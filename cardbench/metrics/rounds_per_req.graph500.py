"""``boruvka_round`` launches per request in the window on the Graph 500
cell, read as ``rounds_per_req`` reads them: every Borůvka hooking round
of the four passes (the certificate's two forests, the tour's forest, the
components less the bridges), one host sync each."""
from cardbench.parts import find, load_module

read = load_module(find("metrics", "rounds_per_req")).read
