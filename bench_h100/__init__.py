"""The benchmark of ``repro_torch`` on NVIDIA H100 cards (see ``run.py``)."""
