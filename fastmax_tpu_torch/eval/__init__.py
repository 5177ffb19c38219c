"""Evaluation of the port (counterpart of ``fastmax_tpu/eval``)."""
