"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one
H100: whole-graph bridge and cut analyses at the paper's Fig. 2 and Fig. 4
points. ``run.py`` runs one cell; ``harness.py`` says how the parts are
found."""
