"""Multi-GPU serving and training (counterpart of ``fastmax_tpu/parallel/``):
the (data, fsdp, model) mesh on ``torch.distributed`` and the per-leaf cut,
with the training plan's differentiable mode (``sharding.py``), every
collective and its backward (``collectives.py``), ring attention
(``ring_attention.py``) and the sequence-parallel loss and step
(``sequence_parallel.py``). The reference's pipeline schedule, scaling bench
and multi-chip dry run are ROADMAP queue A, A8 slice 3."""
