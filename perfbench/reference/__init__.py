"""The benchmark's plain reference: the model in plain torch
(``model.py``) and the program's dropout draw (``philox.py``). It imports
nothing of the program."""
