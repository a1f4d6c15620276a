"""Checkpoints: per-leaf ``.npy`` files with an atomic commit, in the JAX
package's on-disk layout, so either package reads the other's."""
