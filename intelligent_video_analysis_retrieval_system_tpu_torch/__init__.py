"""IVARS on PyTorch and CUDA: the index-build and text-query serving paths
of ``intelligent_video_analysis_retrieval_system_tpu``, ported to PyTorch
with hand-written Hopper kernels (``csrc/``).

The JAX package is the reference; each module here mirrors the module of
the same name there. This package imports neither JAX nor anything of the
JAX package: what it needs of that package's framework-free modules
(``utils``, ``native``, ``serve``) it keeps as its own copies.
"""

__version__ = "0.1.0"
