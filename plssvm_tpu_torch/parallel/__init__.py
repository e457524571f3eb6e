"""Multi-device training and predict (counterpart of plssvm_tpu/parallel):
the row-sharded ring over a list of devices in one process (sharded.py)."""
