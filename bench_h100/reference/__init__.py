"""Plain PyTorch references of the benchmark's configurations and protocols.

Nothing here imports the program under test or the JAX package: the
models, the tiled evaluation and the train step are written again from
the published descriptions, in float32 with TF32 off."""
