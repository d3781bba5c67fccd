"""The benchmark of the PyTorch and CUDA port
(``intelligent_video_analysis_retrieval_system_tpu_torch``) on an NVIDIA H100.

``python3 -m perfbench --workload <name> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` (see :mod:`perfbench.run`).
"""
