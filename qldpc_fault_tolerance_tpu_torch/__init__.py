"""PyTorch/CUDA port of qldpc_fault_tolerance_tpu.

Code-capacity WER of CSS codes under depolarizing noise, decoded by min-sum
BP or BP + ordered-statistics decoding, on one NVIDIA GPU.  The port imports
torch and numpy only; its two hand-written Hopper kernels (``csrc/``) are
built with nvcc at first use.  Entry points run on ``device="cuda"`` unless
the caller passes ``device="cpu"``.
"""
