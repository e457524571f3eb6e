"""LIBSVM model file parsing and writing.

reference: include/plssvm/detail/io/libsvm_model_parsing.hpp —
header ``svm_type c_svc / kernel_type / [degree/gamma/coef0] / nr_class /
total_sv / rho / label / nr_sv / SV`` followed by one ``alpha idx:val ...``
row per support vector, grouped per class.  The parser rejects parameters
irrelevant to the stored kernel (e.g. an explicit gamma in a linear-kernel
model, libsvm_model_parsing.hpp:201-224) and validates all header
cross-consistency rules; the writer groups support vectors by class in
``different_labels()`` order (libsvm_model_parsing.hpp:294-500).

Multiclass EXTENSION (the reference rejects nr_class > 2,
libsvm_model_parsing.hpp:268) — two layouts, auto-detected from the SV
rows' leading-coefficient count:

- **one-vs-all** (C leading alpha columns, C rho values): column c belongs
  to the "class c vs rest" machine — this framework's OAA block-CG output;
- **one-vs-one** (C-1 leading columns, C(C-1)/2 rho values): the STANDARD
  LIBSVM multiclass format (sv_coef layout + pair-ordered rho, see
  plssvm_tpu.oao), so OAO model files interoperate with LIBSVM's own
  svm-train/svm-predict.

``nr_class 2`` files remain byte-for-byte the reference's binary format.
"""

from __future__ import annotations

import datetime
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from ..exceptions import InvalidFileFormatError
from ..parameter import KernelFunctionType, Parameter
from . import libsvm


class ModelHeader(NamedTuple):
    """Parsed model-file header (see :func:`parse_model_header`)."""

    params: Parameter
    #: float array: 1 value for binary/regression models, C for one-vs-all
    #: multiclass, C(C-1)/2 for one-vs-one multiclass
    rho: np.ndarray
    #: label string of each SV row, expanded from label x nr_sv
    #: (None for the no-label epsilon_svr / one_class layouts)
    per_point_labels: Optional[List[str]]
    #: lines consumed by the header, including the ``SV`` marker
    num_header_lines: int
    #: None or the (probA, probB) Platt-calibration arrays
    #: (probB is None for the lone-probA SVR noise scale)
    prob: Optional[Tuple[np.ndarray, Optional[np.ndarray]]]
    #: "c_svc" | "epsilon_svr" | "nu_svr" | "one_class"
    svm_type: str
    #: the header's nr_class (None for the no-label layouts)
    nr_class: Optional[int]
    #: the DISTINCT labels in header order (None for the no-label layouts)
    labels: Optional[List[str]]
    #: the header's total_sv
    total_sv: int


def parse_model_header(lines: List[str]) -> ModelHeader:
    """Parse the model-file header into a :class:`ModelHeader`.

    ``prob`` is ``None`` or ``(probA, probB)`` float arrays from the optional
    LIBSVM probability-calibration header lines (EXTENSION — the reference
    has no probability support; LIBSVM writes these for ``-b 1`` models).

    reference: libsvm_model_parsing.hpp:83-272 (parse_libsvm_model_header).
    """
    params = Parameter()
    rho: Optional[np.ndarray] = None
    prob_a: Optional[np.ndarray] = None
    prob_b: Optional[np.ndarray] = None
    num_support_vectors: Optional[int] = None
    nr_class: Optional[int] = None
    labels: Optional[List[str]] = None
    nr_sv: Optional[List[int]] = None
    svm_type: Optional[str] = None
    kernel_type_set = False

    header_line = 0
    found_sv = False
    for header_line, raw in enumerate(lines):
        line = raw.strip()
        lower = line.lower()
        # value = everything after the key token (any whitespace separator —
        # libsvm itself tokenizes with fscanf, so tabs are legal)
        parts = lower.split(None, 1)
        value = parts[1].strip() if len(parts) > 1 else ""
        # token-EXACT key matching (libsvm tokenizes with fscanf): a
        # startswith would silently misparse unknown keys sharing a
        # prefix ('gamma_x 0.5' must hit the unrecognized-entry error,
        # not set gamma)
        key = parts[0] if parts else ""

        if key == "svm_type":
            # c_svc = classification; epsilon_svr / nu_svr = regression
            # (EXTENSION: LS-SVR models are stored in LIBSVM's epsilon_svr
            # layout — the prediction function sum_i alpha_i k(x_i, x) - rho
            # is identical, so the files interoperate with LIBSVM tools,
            # even though the TRAINING loss differs: least-squares here vs
            # epsilon-insensitive there)
            # one_class (EXTENSION): LIBSVM's one-class layout — same
            # no-label header/SV grammar as the SVR types; the decision
            # function sum_i alpha_i k(x_i, x) - rho is identical, so
            # svm-train -s 2 models load unchanged
            if value not in ("c_svc", "epsilon_svr", "nu_svr", "one_class"):
                raise InvalidFileFormatError(
                    "Can only use c_svc, epsilon_svr, nu_svr, or one_class "
                    f"as svm_type, but '{value}' was given!"
                )
            svm_type = value
        elif key == "kernel_type":
            try:
                params.kernel_type.value = KernelFunctionType.from_string(value)
            except Exception:
                raise InvalidFileFormatError(
                    f"Unrecognized kernel type '{value}'!"
                ) from None
            kernel_type_set = True
        elif key == "gamma":
            params.gamma.value = _to_float(value, "gamma")
        elif key == "degree":
            params.degree.value = _to_int(value, "degree")
        elif key == "coef0":
            params.coef0.value = _to_float(value, "coef0")
        elif key == "nr_class":
            nr_class = _to_int(value, "nr_class")
        elif key == "total_sv":
            num_support_vectors = _to_int(value, "total_sv")
            if num_support_vectors == 0:
                raise InvalidFileFormatError(
                    "The number of support vectors must be greater than 0!"
                )
        elif key == "rho":
            rho = np.asarray(
                [_to_float(tok, "rho") for tok in value.split()], dtype=np.float64
            )
            if rho.size == 0:
                raise InvalidFileFormatError("Missing rho value!")
        elif key == "proba":
            prob_a = np.asarray(
                [_to_float(tok, "probA") for tok in value.split()],
                dtype=np.float64,
            )
        elif key == "probb":
            prob_b = np.asarray(
                [_to_float(tok, "probB") for tok in value.split()],
                dtype=np.float64,
            )
        elif key == "label":
            # preserve the original case of the labels
            orig_parts = line.split(None, 1)
            labels = orig_parts[1].split() if len(orig_parts) > 1 else []
            if len(labels) < 2:
                raise InvalidFileFormatError(
                    f"At least two labels must be set, but only {len(labels)} "
                    f"label ([{', '.join(labels)}]) was given!"
                )
            if len(set(labels)) != len(labels):
                raise InvalidFileFormatError(
                    f"Provided {len(labels)} labels but only {len(set(labels))} "
                    "of them was/where unique!"
                )
        elif key == "nr_sv":
            try:
                nr_sv = [int(tok) for tok in value.split()]
            except ValueError:
                raise InvalidFileFormatError(
                    f"Can't convert nr_sv values '{value}' to integers!"
                ) from None
            if len(nr_sv) < 2:
                raise InvalidFileFormatError(
                    f"At least two nr_sv must be set, but only {len(nr_sv)} "
                    f"([{', '.join(map(str, nr_sv))}]) was given!"
                )
            if any(c <= 0 for c in nr_sv):
                # a non-positive class count would desync the header's
                # nr_class from the classes actually present in the SV
                # block (libsvm only writes classes seen in training)
                raise InvalidFileFormatError(
                    f"Each nr_sv count must be greater than 0, but "
                    f"[{', '.join(map(str, nr_sv))}] was given!"
                )
        elif lower == "sv":
            found_sv = True
            break
        else:
            raise InvalidFileFormatError(
                f"Unrecognized header entry '{raw}'! Maybe SV is missing?"
            )

    if svm_type is None:
        raise InvalidFileFormatError("Missing svm_type!")
    if not kernel_type_set:
        raise InvalidFileFormatError("Missing kernel_type!")
    regression = svm_type != "c_svc"

    # reject explicitly-set parameters the kernel does not use
    # (reference: libsvm_model_parsing.hpp:201-224)
    kt = params.kernel_type.value
    if kt == KernelFunctionType.LINEAR:
        if not params.degree.is_default():
            raise InvalidFileFormatError(
                "Explicitly provided a value for the degree parameter which is "
                "not used in the linear kernel!"
            )
        if not params.gamma.is_default():
            raise InvalidFileFormatError(
                "Explicitly provided a value for the gamma parameter which is "
                "not used in the linear kernel!"
            )
        if not params.coef0.is_default():
            raise InvalidFileFormatError(
                "Explicitly provided a value for the coef0 parameter which is "
                "not used in the linear kernel!"
            )
    elif kt == KernelFunctionType.RBF:
        if not params.degree.is_default():
            raise InvalidFileFormatError(
                "Explicitly provided a value for the degree parameter which is "
                "not used in the radial basis function kernel!"
            )
        if not params.coef0.is_default():
            raise InvalidFileFormatError(
                "Explicitly provided a value for the coef0 parameter which is "
                "not used in the radial basis function kernel!"
            )
    elif kt == KernelFunctionType.SIGMOID:
        if not params.degree.is_default():
            raise InvalidFileFormatError(
                "Explicitly provided a value for the degree parameter which is "
                "not used in the sigmoid kernel!"
            )
    elif kt in (KernelFunctionType.LAPLACIAN, KernelFunctionType.CHI_SQUARED):
        name = (
            "laplacian" if kt == KernelFunctionType.LAPLACIAN else "chi-squared"
        )
        if not params.degree.is_default():
            raise InvalidFileFormatError(
                "Explicitly provided a value for the degree parameter which is "
                f"not used in the {name} kernel!"
            )
        if not params.coef0.is_default():
            raise InvalidFileFormatError(
                "Explicitly provided a value for the coef0 parameter which is "
                f"not used in the {name} kernel!"
            )

    if num_support_vectors is None:
        raise InvalidFileFormatError("Missing total number of support vectors total_sv!")
    if rho is None:
        raise InvalidFileFormatError("Missing rho value!")
    if regression:
        # LIBSVM SVR headers carry neither label nor nr_sv (and write a
        # vestigial "nr_class 2"); a single rho value is required.  libsvm's
        # -b 1 SVR models write a LONE probA line (the Laplace noise scale;
        # 'regression has probA only' in svm.cpp) — accept it without probB
        if rho.size != 1:
            raise InvalidFileFormatError(
                f"Expected 1 rho value for a {svm_type} model, but "
                f"{rho.size} were given!"
            )
        prob: Optional[tuple] = None
        if prob_a is not None:
            # a lone scalar: the Laplace noise scale (SVR) or density
            # threshold — never the per-sigmoid vectors of classification
            if prob_a.size != 1 or (prob_b is not None and prob_b.size != 1):
                raise InvalidFileFormatError(
                    f"Expected 1 probA/probB value for a {svm_type} model, "
                    f"but {prob_a.size}"
                    f"{'' if prob_b is None else f'/{prob_b.size}'} "
                    "were given!"
                )
            prob = (prob_a, prob_b)
        elif prob_b is not None:
            raise InvalidFileFormatError(
                "probB without probA is not a valid model header!"
            )
        if not found_sv or header_line + 1 >= len(lines):
            raise InvalidFileFormatError(
                "Can't parse file: no support vectors are given or SV is missing!"
            )
        return ModelHeader(
            params, rho, None, header_line + 1, prob, svm_type,
            None, None, num_support_vectors,
        )
    if nr_class is None:
        raise InvalidFileFormatError("Missing number of different classes nr_class!")
    if labels is None:
        raise InvalidFileFormatError("Missing class label specification!")
    if nr_class != len(labels):
        raise InvalidFileFormatError(
            f"The number of classes (nr_class) is {nr_class}, but the provided "
            f"number of different labels is {len(labels)} (label)!"
        )
    if nr_sv is None:
        raise InvalidFileFormatError("Missing number of support vectors per class nr_sv!")
    if nr_class != len(nr_sv):
        raise InvalidFileFormatError(
            f"The number of classes (nr_class) is {nr_class}, but the provided "
            f"number of different labels is {len(nr_sv)} (nr_sv)!"
        )
    if sum(nr_sv) != num_support_vectors:
        raise InvalidFileFormatError(
            f"The total number of support vectors is {num_support_vectors}, "
            f"but the sum of nr_sv is {sum(nr_sv)}!"
        )
    if not found_sv or header_line + 1 >= len(lines):
        raise InvalidFileFormatError(
            "Can't parse file: no support vectors are given or SV is missing!"
        )

    # expand per-class counts into the per-point label vector
    per_point_labels: List[str] = []
    for lab, count in zip(labels, nr_sv):
        per_point_labels.extend([lab] * count)

    # binary: exactly one rho; multiclass: C one-vs-all values (extension)
    # or C(C-1)/2 one-vs-one values (standard LIBSVM multiclass layout) —
    # the SV rows' coefficient-column count resolves the format
    if nr_class == 2:
        allowed_rho = (1,)
    else:
        allowed_rho = tuple(
            sorted({nr_class, nr_class * (nr_class - 1) // 2})
        )
    if rho.size not in allowed_rho:
        raise InvalidFileFormatError(
            f"Expected {' or '.join(map(str, allowed_rho))} rho value(s) for "
            f"nr_class {nr_class}, but {rho.size} were given!"
        )

    # optional Platt calibration: probA and probB come as a pair with one
    # value per sigmoid — always the same count as rho (1 binary, C
    # one-vs-all, C(C-1)/2 one-vs-one, exactly LIBSVM's layout)
    prob: Optional[tuple] = None
    if (prob_a is None) != (prob_b is None):
        raise InvalidFileFormatError(
            "probA and probB must both be given (or neither)!"
        )
    if prob_a is not None:
        if prob_a.size != rho.size or prob_b.size != rho.size:
            raise InvalidFileFormatError(
                f"Expected {rho.size} probA/probB value(s) matching the rho "
                f"count, but {prob_a.size}/{prob_b.size} were given!"
            )
        prob = (prob_a, prob_b)

    return ModelHeader(
        params, rho, per_point_labels, header_line + 1, prob, svm_type,
        nr_class, labels, num_support_vectors,
    )


def _to_float(value: str, name: str) -> float:
    try:
        return float(value)
    except ValueError:
        raise InvalidFileFormatError(
            f"Can't convert '{value}' to a value of type real_type ({name})!"
        ) from None


def _to_int(value: str, name: str) -> int:
    try:
        return int(value)
    except ValueError:
        raise InvalidFileFormatError(
            f"Can't convert '{value}' to a value of type int ({name})!"
        ) from None


def _check_sv_count(n_found: int, header: ModelHeader) -> None:
    """Require the SV-block row count to match the header's promise."""
    expected = (
        len(header.per_point_labels)
        if header.per_point_labels is not None
        else header.total_sv
    )
    if expected != n_found:
        raise InvalidFileFormatError(
            f"Found {n_found} support vectors, but expected {expected}!"
        )


def _count_leading_coeffs(line: str) -> int:
    """Number of leading tokens without ':' (the alpha/sv_coef columns)."""
    n = 0
    for tok in line.split():
        if ":" in tok:
            break
        n += 1
    return n


def _resolve_multiclass_lead(
    first_sv_line: str, nr_class: int, rho_size: int
) -> int:
    """Resolve the multiclass layout from the first SV row.

    C leading coefficient columns = one-vs-all (extension, C rho values);
    C-1 columns = standard LIBSVM one-vs-one (C(C-1)/2 rho values).  The
    rho count must agree with the resolved layout.
    """
    n_lead = _count_leading_coeffs(first_sv_line)
    n_pairs = nr_class * (nr_class - 1) // 2
    if n_lead == nr_class:
        layout, expected_rho = "one-vs-all", nr_class
    elif n_lead == nr_class - 1:
        layout, expected_rho = "one-vs-one", n_pairs
    else:
        raise InvalidFileFormatError(
            f"Expected {nr_class} (one-vs-all) or {nr_class - 1} "
            f"(one-vs-one) leading alpha values per support vector in a "
            f"{nr_class}-class model, but found {n_lead}!"
        )
    if rho_size != expected_rho:
        raise InvalidFileFormatError(
            f"The SV rows' {n_lead} alpha columns imply the {layout} layout "
            f"with {expected_rho} rho value(s), but {rho_size} were given!"
        )
    return n_lead


def parse_model_file(
    filename: str, dtype: np.dtype = np.float64
) -> Tuple[
    Parameter, np.ndarray, np.ndarray, np.ndarray, Optional[List[str]],
    Optional[tuple], str,
]:
    """Read a full model file.

    Returns ``(params, rho, support_vectors, alpha, labels, prob, svm_type)``
    with ``prob`` either ``None`` or the ``(probA, probB)`` Platt-calibration
    arrays from the optional probability header lines and ``svm_type`` the
    header's type string (c_svc / epsilon_svr / nu_svr / one_class).  For a binary
    model ``rho`` has 1 entry and ``alpha`` is (n_sv,): the alpha values are
    the "label column" of the SV rows (reference: model.hpp:169-201 — alpha
    is parsed as the label of a regular LIBSVM data section).  For a
    one-vs-all multiclass model (extension) ``rho`` has C entries and
    ``alpha`` is (n_sv, C) — C leading columns per SV row.

    The JAX package's native SV-block parser (plssvm_tpu/native/) is not
    ported yet (ROADMAP Queue 1, item 1); this Python path raises the exact
    reference messages.
    """
    from .file_reader import read_lines

    lines = read_lines(filename, comment="#")
    header = parse_model_header(lines)
    params, rho, labels = header.params, header.rho, header.per_point_labels
    prob, svm_type = header.prob, header.svm_type
    sv_lines = lines[header.num_header_lines:]
    # labels is None for regression (epsilon_svr) models — single alpha
    # column, exactly the binary SV-row grammar
    nr_class = 2 if labels is None else header.nr_class

    if nr_class == 2:
        data, alpha_strings = libsvm.parse_libsvm_lines(sv_lines, dtype=dtype)
        if alpha_strings is None:
            raise InvalidFileFormatError("Missing alpha values in the model file!")
        alpha = np.asarray(alpha_strings, dtype=dtype)
    else:
        # multiclass: strip the leading coefficient columns (C for
        # one-vs-all, C-1 for one-vs-one — resolved from the first row),
        # parse the remaining feature entries as an unlabeled LIBSVM section
        n_lead = _resolve_multiclass_lead(sv_lines[0], nr_class, rho.size)
        layout = "one-vs-all" if n_lead == nr_class else "one-vs-one"
        alpha_rows: List[List[float]] = []
        feature_lines: List[str] = []
        for line in sv_lines:
            tokens = line.split()
            if (
                len(tokens) < n_lead
                or any(":" in tok for tok in tokens[:n_lead])
                or (len(tokens) > n_lead and ":" not in tokens[n_lead])
            ):
                raise InvalidFileFormatError(
                    f"Expected {n_lead} leading alpha values per support "
                    f"vector in a {nr_class}-class {layout} model!"
                )
            alpha_rows.append(
                [_to_float(tok, "alpha") for tok in tokens[:n_lead]]
            )
            feature_lines.append(" ".join(tokens[n_lead:]))
        data, _ = libsvm.parse_libsvm_lines(feature_lines, dtype=dtype)
        alpha = np.asarray(alpha_rows, dtype=dtype)

    _check_sv_count(data.shape[0], header)
    return params, rho, data, alpha, labels, prob, svm_type


def write_model_file(
    filename: str,
    params: Parameter,
    rho,
    alpha: np.ndarray,
    support_vectors: np.ndarray,
    labels: Optional[np.ndarray],
    different_labels: Optional[List[str]],
    prob_a: Optional[np.ndarray] = None,
    prob_b: Optional[np.ndarray] = None,
    regression: bool = False,
    one_class: bool = False,
) -> None:
    """Write the model file, grouping SVs per class in ``different_labels`` order.

    reference: libsvm_model_parsing.hpp:294-500 (write_libsvm_model_data).
    Binary models (scalar ``rho``, 1-D ``alpha``) keep the reference's exact
    format; one-vs-all multiclass models (``rho`` (C,), ``alpha`` (n_sv, C))
    write C rho values and C alpha columns per SV row.  ``prob_a``/``prob_b``
    (when both given) add the LIBSVM probA/probB calibration header lines
    (plssvm_tpu.probability) — absent by default, keeping the output
    byte-identical to the reference's.
    """
    alpha = np.asarray(alpha)
    rho_vals = np.atleast_1d(np.asarray(rho, dtype=np.float64))
    kt = params.kernel_type.value

    header = [f"# This model file has been created at {datetime.datetime.now().isoformat()}"]
    # LS-SVR regression models use LIBSVM's epsilon_svr layout; one-class
    # models use LIBSVM's one_class layout — both share the no-label SV
    # grammar (identical prediction function; see parse_model_header)
    if one_class:
        header.append("svm_type one_class")
        regression = True  # reuse the no-label layout below
    else:
        header.append("svm_type epsilon_svr" if regression else "svm_type c_svc")
    header.append(f"kernel_type {kt}")
    if kt == KernelFunctionType.POLYNOMIAL:
        header.append(f"degree {params.degree.value}")
        header.append(f"gamma {_fmt_g(params.gamma.value)}")
        header.append(f"coef0 {_fmt_g(params.coef0.value)}")
    elif kt == KernelFunctionType.SIGMOID:
        header.append(f"gamma {_fmt_g(params.gamma.value)}")
        header.append(f"coef0 {_fmt_g(params.coef0.value)}")
    elif kt in (
        KernelFunctionType.RBF,
        KernelFunctionType.LAPLACIAN,
        KernelFunctionType.CHI_SQUARED,
    ):
        header.append(f"gamma {_fmt_g(params.gamma.value)}")
    n_sv = alpha.shape[0]
    if regression:
        # LIBSVM SVR headers: vestigial nr_class 2, no label / nr_sv lines
        header.append("nr_class 2")
        header.append(f"total_sv {n_sv}")
        header.append(f"rho {_fmt_g(rho_vals[0])}")
    else:
        labels = np.asarray([str(lab) for lab in labels])
        counts = [int(np.sum(labels == lab)) for lab in different_labels]
        header.append(f"nr_class {len(different_labels)}")
        header.append(f"label {' '.join(str(lab) for lab in different_labels)}")
        header.append(f"total_sv {len(labels)}")
        header.append(f"nr_sv {' '.join(str(c) for c in counts)}")
        header.append(f"rho {' '.join(_fmt_g(r) for r in rho_vals)}")
    if prob_a is not None:
        header.append(
            f"probA {' '.join(_fmt_g(v) for v in np.atleast_1d(prob_a))}"
        )
        # classification sigmoids always pair probB; libsvm SVR models
        # carry probA (the Laplace noise scale) alone
        if prob_b is not None:
            header.append(
                f"probB {' '.join(_fmt_g(v) for v in np.atleast_1d(prob_b))}"
            )
    header.append("SV")

    sv = np.asarray(support_vectors)
    if regression:
        # regression SVs keep the original row order (no class grouping)
        order = np.arange(n_sv)
    else:
        # class-grouped row order (ascending within each class, classes in
        # different_labels order — identical to the Python loop below)
        order = np.concatenate(
            [np.nonzero(labels == str(lab))[0] for lab in different_labels]
        )
        if order.shape[0] != n_sv:
            # a label outside different_labels would otherwise truncate
            # the output (the header promises total_sv rows)
            raise InvalidFileFormatError(
                f"every support-vector label must appear in the model's "
                f"class list: {order.shape[0]} of {n_sv} rows matched "
                f"{list(different_labels)}!"
            )

    with open(filename, "w", encoding="utf-8") as fh:
        fh.write("\n".join(header))
        fh.write("\n")
        for i in order:
            row = sv[i]
            cols = np.nonzero(row != 0.0)[0]
            entries = "".join(f"{j + 1}:{row[j]:.10e} " for j in cols)
            if alpha.ndim == 1:
                coeffs = _fmt_g(alpha[i])
            else:
                coeffs = " ".join(_fmt_g(a) for a in alpha[i])
            fh.write(f"{coeffs} {entries}\n")


def _fmt_g(value: float) -> str:
    """Format a float the way fmt's ``{}`` does (shortest round-trip)."""
    return repr(float(value))
