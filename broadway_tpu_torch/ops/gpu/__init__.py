"""Device stages of the torch port: integer tensor ops (the plain
versions) and the wrappers of the hand-written CUDA kernels."""
