"""Plain reference of the template-switch alignment problem (no kernels, no
import of the program under test): the optimum by a dense dynamic programme
in plain PyTorch (`dp.py`) and a walk that prices a recorded alignment
(`pricer.py`), both over the cost model of a configuration file (`model.py`)."""
