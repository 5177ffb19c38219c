"""Checkpoint tools of the port (counterparts of ``fastmax_tpu/scripts``)."""
