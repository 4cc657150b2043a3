"""Multi-device runs over ``torch.distributed``: the all-gather mode
(:mod:`sharding`) and the 1-D slab halo mode (:mod:`halo`), one process and
one device a rank (:mod:`launch`), with the ring collectives of
:mod:`comm`.  Counterpart of ``particlemethod_fsi_tpu/parallel/``."""
