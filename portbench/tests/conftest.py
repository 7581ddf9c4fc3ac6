"""The cat3dgs cells' tiny sizes and faults, added before the whole-run
tests collect their cells (portbench/tests/tiny_cat.py)."""

from portbench.tests import tiny_cat

tiny_cat.register()
