"""The benchmark harness of the PyTorch / CUDA port (``dcol_tpu_torch``).

Everything a cell needs is found by name: its configuration
(``configs/<name>.json`` with its plain reference ``configs/<name>_ref.py``),
its traffic mix (``mixes/<name>.json``), its limits
(``limits/<cell>.json``) and each metric's reader (``metrics/<name>.py``).
"""
