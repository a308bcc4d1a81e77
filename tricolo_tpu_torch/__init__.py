"""TriCoLo on PyTorch and CUDA (NVIDIA Hopper).

The port of ``tricolo_tpu`` (JAX on TPU), package by package, held against
it as the reference. It imports nothing of the JAX package. It serves and
trains Tri(I+V) text-to-shape retrieval: config, the windowed_compact
loaders, the BiGRU / MVCNN-ResNet18 / windowed VoxelCNN encoders, the
retrieval server, the NT-Xent losses, the Trainer, and six hand-written
sm_90a kernels (``ops``).
"""
