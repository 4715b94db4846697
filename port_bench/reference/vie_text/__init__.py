"""A frozen copy of the port's Vietnamese frontend (``text/g2p.py``,
``phonology.py``, ``symbols.py``, ``sequence.py``) at the benchmark's first
commit: text to phoneme ids, for the reference's side of the comparison."""
