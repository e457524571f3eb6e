"""Multi-device training and predict (counterpart of plssvm_tpu/parallel):
the row-sharded ring over a list of devices in one process (sharded.py),
and over the ranks of a ``torch.distributed`` job, one shard a process
(multihost.py)."""
