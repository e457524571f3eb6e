"""Rehearse a multi-process job on one host: W ranks with torchrun's
environment, each running a list of fits and predicts.

``launch(spec, world, out_dir)`` starts W processes of this module
(``--worker``), each with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT`` set as torchrun sets them, the rank's
device (``PLSSVM_TPU_TORCH_RANK_DEVICE``: ``cpu``, or ``cuda:0`` for every
rank of a one-card rehearsal), the backend (gloo by default: NCCL puts no
two ranks on one card) and a timeout for every collective.  It waits for
all of them within ``timeout`` seconds and raises, with each rank's last
lines of output, when one fails or hangs (the others are killed then).

A spec is ``{"tasks": [...]}``; each task a dict with ``"name"`` and
``"op"``:

- ``fit``: ``CSVM(**csvm).fit_multihost(file, **fit)``; ``warm_start`` a
  model file for ``initial_model``, ``interrupt_at_barrier`` k stops every
  rank after its k-th barrier of the fit (a checkpointed fit interrupted
  after a save), ``expect_error`` records the error every rank raised (a
  ``debug`` guard) instead of failing, ``predict`` a test file that the
  fitted model scores with ``predict_multihost`` (any fit op; its launches
  apart);
- ``one_class``: ``fit_one_class_multihost(CSVM(**csvm), file, **fit)``;
- ``nystroem``: ``nystroem_fit_multihost(CSVM(**csvm), file, **fit)``;
- ``predict``: ``predict_multihost(CSVM(**csvm), Model.load(model), file)``;
- ``cli_train`` / ``cli_predict``: the CLI's ``main(argv)``;

a fit with ``"save"`` writes its model there from rank 0.  Each rank writes
``rank{r}.json`` to ``out_dir`` (per task: seconds, iterations, the
window and rows the rank held, staged bytes, the kernels' launches and the
plain versions' calls during the task, the files it wrote, the CLI's
return code) and ``{name}.rank{r}.npz`` (alpha, rho, predictions), and the seconds from its
launch to its first task (``startup_s``: the interpreter, torch, the process
group and, on a card, CUDA's context).  The worker imports no ``jax`` and
records that it did not.

Run ``python -m plssvm_tpu_torch.tools.multihost_rehearsal --world 2
--spec spec.json --out DIR [--device cpu] [--backend gloo]`` to launch
from the shell.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from typing import List

#: the modules whose launch and plain-call counters a task records
COUNTED = ("gram_matvec", "gram_matmat", "distance", "kernel_matrix", "matvec", "pairs")


def free_port() -> int:
    """A free TCP port on localhost for the rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(spec: dict, world: int, out_dir: str, *, device: str = "cpu",
           backend: str = "gloo", timeout: float = 300.0, threads: int = 1) -> List[dict]:
    """Run ``spec`` on ``world`` ranks; returns each rank's record, in rank
    order.  Raises RuntimeError when a rank fails or the job outlasts
    ``timeout`` seconds, which also bounds each collective (every rank is
    killed first)."""
    os.makedirs(out_dir, exist_ok=True)
    spec_path = os.path.join(out_dir, "spec.json")
    with open(spec_path, "w", encoding="utf-8") as fh:
        json.dump(spec, fh)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    port = free_port()
    procs, logs, failed = [], [], None
    try:
        for rank in range(world):
            rank_env = dict(os.environ)
            rank_env.update(
                RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                PLSSVM_TPU_TORCH_RANK_DEVICE=device, PLSSVM_TPU_TORCH_DIST_BACKEND=backend,
                PLSSVM_TPU_TORCH_DIST_TIMEOUT=str(timeout),
                OMP_NUM_THREADS=str(threads), MKL_NUM_THREADS=str(threads),
                PLSSVM_TPU_TORCH_REHEARSAL_LAUNCHED=repr(time.time()),
                PYTHONPATH=os.pathsep.join([root] + [p for p in rank_env.get(
                    "PYTHONPATH", "").split(os.pathsep) if p]),
            )
            logs.append(open(os.path.join(out_dir, f"rank{rank}.log"), "w+", encoding="utf-8"))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "plssvm_tpu_torch.tools.multihost_rehearsal",
                 "--worker", spec_path, "--out", out_dir, "--threads", str(threads)],
                env=rank_env, stdout=logs[-1], stderr=subprocess.STDOUT, cwd=root))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad or time.monotonic() > deadline:
                failed = (f"rank(s) {bad} failed" if bad
                          else f"the job outlasted its {timeout} s")
                break
            time.sleep(0.05)
        if failed is None:
            bad = [r for r, p in enumerate(procs) if p.returncode != 0]
            failed = f"rank(s) {bad} failed" if bad else None
    finally:
        # no rank outlives the launch
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        tails = []
        for rank, (proc, log) in enumerate(zip(procs, logs)):
            log.seek(0)
            tails.append(f"--- rank {rank} (exit {proc.returncode}) ---\n"
                         + "".join(log.readlines()[-40:]))
        for log in logs:
            log.close()
    if failed is not None:
        raise RuntimeError(f"multi-process rehearsal: {failed}\n" + "\n".join(tails))
    records = []
    for rank in range(world):
        with open(os.path.join(out_dir, f"rank{rank}.json"), encoding="utf-8") as fh:
            records.append(json.load(fh))
    return records


def load_arrays(out_dir: str, name: str, rank: int) -> dict:
    """The arrays a task of ``rank`` saved (alpha, rho, predictions)."""
    import numpy as np

    with np.load(os.path.join(out_dir, f"{name}.rank{rank}.npz"), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------


class _Interrupted(Exception):
    """Raised on every rank after the same barrier: a fit stopped as a
    killed job would stop, its checkpoint left on disk."""


def _counters() -> dict:
    """Every kernel launch and plain-call counter of the port's ops."""
    import importlib

    counts = {}
    for name in COUNTED:
        module = importlib.import_module(f"plssvm_tpu_torch.ops.{name}")
        for attr, value in vars(module).items():
            if (attr.endswith("launches") or attr.endswith("_calls")) \
                    and isinstance(value, int) and not isinstance(value, bool):
                counts[f"{name}.{attr}"] = value
    return counts


def _diff(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}


def _run_task(task: dict, rank: int, out_dir: str, writes: list) -> dict:
    import numpy as np
    import torch

    import plssvm_tpu_torch as port
    from plssvm_tpu_torch.parallel import multihost

    op = task["op"]
    record = {"name": task["name"], "op": op}
    arrays = {}
    if op in ("fit", "one_class", "nystroem", "predict"):
        svm = port.CSVM(**task.get("csvm", {}))
    port.global_tracker.clear()
    multihost.reset_counts()
    before = _counters()
    start = time.perf_counter()
    if op == "fit":
        kw = dict(task.get("fit", {}))
        if task.get("warm_start"):
            kw["initial_model"] = port.Model.load(task["warm_start"],
                                                  dtype=np.dtype(svm.dtype))
        try:
            model = svm.fit_multihost(task["file"], **kw)
        except _Interrupted:
            record["interrupted"] = True
            model = None
        except port.PLSSVMError as exc:
            if not task.get("expect_error"):
                raise
            record["error"] = f"{type(exc).__name__}: {exc}"
            model = None
    elif op == "one_class":
        model = port.fit_one_class_multihost(svm, task["file"], **task.get("fit", {}))
    elif op == "nystroem":
        model = port.nystroem_fit_multihost(svm, task["file"], **task.get("fit", {}))
    elif op == "predict":
        model = None
        predicted, _, n = multihost.predict_multihost(
            svm, port.Model.load(task["model"], dtype=np.dtype(svm.dtype)), task["file"])
        arrays["predictions"] = np.asarray(predicted)
    elif op in ("cli_train", "cli_predict"):
        from plssvm_tpu_torch.cli import predict as cli_predict
        from plssvm_tpu_torch.cli import train as cli_train

        main = cli_train.main if op == "cli_train" else cli_predict.main
        model = None
        record["rc"] = main(task["argv"])
    else:
        raise ValueError(f"unknown task op {op!r}")
    for dev in range(torch.cuda.device_count()):
        torch.cuda.synchronize(dev)
    record["seconds"] = time.perf_counter() - start
    record["launches"] = _diff(before, _counters())
    record["staged_bytes"] = multihost.staged_bytes
    tracked = port.global_tracker.entries()
    held = dict(tracked.get("multihost", []))
    if "window" in held:
        record["window"] = held["window"]
        record["rows"] = {k[5:]: v for k, v in held.items() if k.startswith("rows_")}
    for category, keys in (("cg", ("iterations", "total_runtime", "solver",
                                   "kernel_matrix_build_time")),
                           ("multihost", ("solve_ms", "setup_ms"))):
        entries = dict(tracked.get(category, []))
        for key in keys:
            if key in entries:
                record[f"{category}.{key}"] = entries[key]
    if model is not None and task.get("predict"):
        # the model in memory, each rank scoring its window of the test file
        mark, begin = _counters(), time.perf_counter()
        predicted, _, _ = multihost.predict_multihost(svm, model, task["predict"])
        for dev in range(torch.cuda.device_count()):
            torch.cuda.synchronize(dev)
        record["predict_seconds"] = time.perf_counter() - begin
        record["predict_launches"] = _diff(mark, _counters())
        arrays["predictions"] = np.asarray(predicted)
    if model is not None:
        arrays["alpha"] = np.asarray(model.alpha)
        arrays["rho"] = np.asarray(model.rho, dtype=np.float64)
        record["n_iter"] = int(getattr(model, "n_iter", 0) or 0)
        record["num_support_vectors"] = int(model.num_support_vectors)
        if task.get("save") and rank == 0:
            model.save(task["save"])
    if arrays:
        np.savez(os.path.join(out_dir, f"{task['name']}.rank{rank}.npz"), **arrays)
    record["writes"] = [w for w in writes]
    writes.clear()
    return record


def worker(spec_path: str, out_dir: str, threads: int) -> int:
    import torch

    torch.set_num_threads(threads)
    import plssvm_tpu_torch as port
    from plssvm_tpu_torch.parallel import multihost
    from plssvm_tpu_torch.solver import checkpoint

    import torch.distributed as dist

    port.set_verbosity("quiet")
    with open(spec_path, encoding="utf-8") as fh:
        spec = json.load(fh)
    multihost.initialize_distributed()
    rank = int(os.environ.get("RANK", "0"))

    # every file a rank writes, recorded: only rank 0 may write
    writes: list = []

    def recorded(kind, fn):
        def call(*args, **kwargs):
            path = args[1] if kind == "model" else args[0]
            writes.append([kind, str(path)])
            return fn(*args, **kwargs)
        return call

    port.Model.save = recorded("model", port.Model.save)
    checkpoint.save_checkpoint = recorded("checkpoint", checkpoint.save_checkpoint)
    checkpoint.save_multi_checkpoint = recorded("checkpoint",
                                                checkpoint.save_multi_checkpoint)
    port.global_tracker.save = recorded("tracker", port.global_tracker.save)
    original_barrier = multihost.RankGroup.barrier

    launched = os.environ.get("PLSSVM_TPU_TORCH_REHEARSAL_LAUNCHED")
    startup = None if launched is None else time.time() - float(launched)
    records = []
    for task in spec["tasks"]:
        stop_at = task.get("interrupt_at_barrier")
        if stop_at is not None:
            seen = [0]

            def barrier(self, _seen=seen, _stop=int(stop_at)):
                original_barrier(self)
                _seen[0] += 1
                if _seen[0] == _stop:
                    raise _Interrupted()

            multihost.RankGroup.barrier = barrier
        try:
            records.append(_run_task(task, rank, out_dir, writes))
        finally:
            multihost.RankGroup.barrier = original_barrier
        # what rank 0 wrote is there for the next task of every rank
        if dist.is_initialized():
            dist.barrier()
    result = {"rank": rank, "world": int(os.environ.get("WORLD_SIZE", "1")),
              "startup_s": startup, "tasks": records, "jax_imported": "jax" in sys.modules,
              "plssvm_tpu_imported": "plssvm_tpu" in sys.modules}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w", encoding="utf-8") as fh:
        json.dump(result, fh)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m plssvm_tpu_torch.tools.multihost_rehearsal",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--worker", metavar="SPEC", help=argparse.SUPPRESS)
    parser.add_argument("--world", type=int, default=2, help="number of ranks")
    parser.add_argument("--spec", help="the JSON spec of tasks")
    parser.add_argument("--out", required=True, help="directory of the ranks' records")
    parser.add_argument("--device", default="cpu",
                        help="every rank's device: cpu, or cuda:0 for a one-card rehearsal")
    parser.add_argument("--backend", default="gloo", help="gloo (default) or nccl")
    parser.add_argument("--timeout", type=float, default=300.0, help="seconds for the job")
    parser.add_argument("--threads", type=int, default=1, help="torch threads a rank")
    args = parser.parse_args(argv)
    if args.worker:
        return worker(args.worker, args.out, args.threads)
    with open(args.spec, encoding="utf-8") as fh:
        spec = json.load(fh)
    records = launch(spec, args.world, args.out, device=args.device, backend=args.backend,
                     timeout=args.timeout, threads=args.threads)
    print(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
