"""The benchmark's CPU tests: ``python -m pytest bench/tests -q`` from the
root of the checkout. The repository's own tests (``tests/``) do not
collect them."""
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
import torch  # noqa: E402

torch.set_num_threads(2)  # the tests run in several workers at once
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
