"""Multi-device runs over ``torch.distributed``: the all-gather mode
(:mod:`sharding`) and the halo mode over 1-D slabs or a 2-axis mesh of
rectangles (:mod:`halo`), one process and one device a rank
(:mod:`launch`), with the ring collectives of :mod:`comm`.  Counterpart of
``particlemethod_fsi_tpu/parallel/``."""
