"""Checkpoints of the port's runtime (torch counterpart of
``repro.checkpoint``): atomic, self-verifying step directories in the JAX
package's on-disk layout."""
