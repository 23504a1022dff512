"""Fused multi-resource BF-J/S slot-step kernel (``csrc/bfjs_mr.cu``) with
its plain PyTorch version."""
