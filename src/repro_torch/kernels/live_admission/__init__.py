"""Device-resident live admission kernel (``csrc/live_admission.cu``) with
its plain PyTorch version."""
