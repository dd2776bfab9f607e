"""Training (counterpart of ``src/repro/training``): optimizers
(``optimizer``), the train step and loop (``train_loop``), int8 gradient
compression, checkpoints in the reference's on-disk format, the synthetic
data streams, and the paths over params and cache trees (``tree``)."""
