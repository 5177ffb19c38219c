"""The C++ packed-dataset loader of the port (counterpart of ``fastmax_tpu/native``)."""
