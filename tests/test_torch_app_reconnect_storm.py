"""The reconnect storm (``tools/chaos.py:run_reconnect_storm``) on the port:
the reference's ``TestOverloadSmoke.test_reconnect_storm_1k_clients`` with
its own assertions (``torch_reference``), and the port's report equal to
the reference's for seeds 0-2. The storm runs on a simulated clock
against the riddler's admission controller: no device, no sockets."""

import pytest
from torch_reference import ported_functions

from fluidframework_tpu.tools import chaos as jax_chaos
from fluidframework_tpu_torch.tools import chaos

_reference = ported_functions(
    "test_chaos", ["TestOverloadSmoke.test_reconnect_storm_1k_clients"])


class TestOverloadSmoke:
    test_reconnect_storm_1k_clients = \
        _reference.test_reconnect_storm_1k_clients


@pytest.mark.parametrize("seed", range(3))
def test_reconnect_storm_report_matches_reference(seed):
    kw = dict(n_clients=1000, seed=seed)
    assert chaos.run_reconnect_storm(**kw) \
        == jax_chaos.run_reconnect_storm(**kw)
