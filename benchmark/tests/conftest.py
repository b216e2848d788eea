"""CPU tests of the benchmark: `python -m pytest benchmark/tests -q` from
the root of the repository. Tests marked `cuda` run one cell on the card
and skip without one."""
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# tiny sizes of each configuration and traffic mix, for runs on the CPU
# (the folding scene keeps its Newton cap: the reference converges fully)
TINY_CONFIG = {"folding": {"table_n": 4}}
TINY_TRAFFIC = {"trajopt": {"compare_iterations": 1}}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_ctx(workload, seed=2**31 + 5, traced=False, control=False):
    """A run's context for `workload` at a tiny size on the CPU."""
    from benchmark import run
    from benchmark.harness import manifest

    man = manifest.manifest()
    ctx = run.make_ctx(man, workload, seed, torch.device("cpu"), traced,
                       control)
    ctx.config["kwargs"].update(TINY_CONFIG[ctx.config["scene"]])
    ctx.traffic.update(TINY_TRAFFIC.get(ctx.traffic["kind"], {}))
    return man, ctx
