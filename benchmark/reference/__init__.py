"""The plain reference of the tracker that the benchmark holds the port to.

Plain PyTorch, float64 by default, written from the configuration's
mathematics (SuPer's preprocessing, embedded-deformation graph, LM warp
solve, warp and surfel fusion): no kernel, no capture, no layout of the
port's.  It imports nothing of the port or of JAX, and takes nothing the
port made but its state before a frame, which it reads field by field.
"""
