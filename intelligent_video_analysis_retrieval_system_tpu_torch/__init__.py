"""IVARS on PyTorch and CUDA: the text-query serving path of
``intelligent_video_analysis_retrieval_system_tpu``, ported to PyTorch with
hand-written Hopper kernels (``csrc/``).

The JAX package is the reference; each module here mirrors the module of
the same name there. This package never imports JAX.
"""

__version__ = "0.1.0"
