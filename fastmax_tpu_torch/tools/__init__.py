"""Counterparts of the int4/NF4 kernel labs of ``tools/`` (the experiment
scripts of the JAX package), under the scripts' names:

* ``int4_opt_r04`` and ``int4_opt_r05``: raw int4 nibbles of the tiled
  layout, f32 and bf16, and the word-streaming probe;
* ``nf4_variants_r04``: the NF4 and int4 variants v1-v12 and their packers;
* ``nf4_lab_r04``: the lab that times them at the Llama-2-7B decode shapes.

Their kernels are in ``lab_kernels`` (K10-K13) or are the port's K1, K8 and
K9 where a lab function equals an already ported one. Run a lab's main on
the card as ``python -m fastmax_tpu_torch.tools.<script>``.
"""
