"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
root of the repo. They run on the CPU at small sizes; a test that needs the
card is marked ``cuda`` and skips without one."""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
for p in (os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))):
    if p not in sys.path:
        sys.path.insert(0, p)
