"""The benchmark harness of the PyTorch and CUDA renderer
(``cudabrot_tpu_torch``): cell files, the run, the trace reduction and
the output check. ``h100bench/run.py`` is its command."""
