"""Multi-GPU serving and training (counterpart of ``fastmax_tpu/parallel/``):
the (data, fsdp, model) mesh on ``torch.distributed`` and the per-leaf cut,
with the training plan's differentiable mode (``sharding.py``), every
collective and its backward (``collectives.py``), ring attention
(``ring_attention.py``), the sequence-parallel loss and step
(``sequence_parallel.py``), GPipe's pipeline schedule over a mesh axis
(``pipeline.py``) and the scaling-efficiency harness (``scaling_bench.py``).
The reference's eight-mode multi-chip dry run is ``graft_entry.py`` at the
package's root."""
