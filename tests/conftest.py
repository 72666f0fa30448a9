import os
import sys

# NOTE: no XLA_FLAGS here on purpose — smoke tests must see 1 CPU device;
# only launch/dryrun.py forces 512 placeholder devices (in its own process).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one; "
                                       "run on the chip)")
