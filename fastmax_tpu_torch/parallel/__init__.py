"""Multi-GPU serving (counterpart of ``fastmax_tpu/parallel/``): the (data,
fsdp, model) mesh on ``torch.distributed`` (``sharding.py``), every
collective of the sharded forward and of the serving plan
(``collectives.py``). The training modes of the reference's
``parallel/`` (ring attention, sequence parallelism, the pipeline, the
scaling bench) are ROADMAP queue A, A8 slice 2."""
