"""The reference's ``tests/test_agents.py`` run against the port: the agent
scheduler, the headless runner and the intelligence agents, locally and
over the port's alfred, each case with the reference's own assertions
(``torch_reference``).

``secure_alfred`` here stands in for ``tests/conftest.py``'s fixture of
the same name, which serves the reference's ``AlfredServer``: this one
serves the port's, with the same tenant and throttling, on the CPU."""

import asyncio
import threading

import pytest
from torch_reference import port_reference

from fluidframework_tpu_torch.server.alfred import AlfredServer
from fluidframework_tpu_torch.server.riddler import TenantManager, Throttler
from fluidframework_tpu_torch.server.routerlicious import RouterliciousService

#: The port's alfred builds its device hosts on the card unless asked.
ADAPT = [('"--port", "0", "--no-merge-host"],',
          '"--port", "0", "--no-merge-host", "--device", "cpu"],')]

port_reference("test_agents", globals(), adapt=ADAPT)


@pytest.fixture()
def secure_alfred():
    """In-process port AlfredServer with auth + tight throttling on a loop
    thread; yields (port, tenant)."""
    tenants = TenantManager()
    tenant = tenants.create_tenant("acme")
    server = AlfredServer(RouterliciousService(), tenants=tenants,
                          throttler=Throttler(rate_per_interval=50,
                                              interval_s=60.0))
    loop = asyncio.new_event_loop()
    started = threading.Event()

    async def run():
        await server.start()
        started.set()

    thread = threading.Thread(target=lambda: (
        loop.run_until_complete(run()), loop.run_forever()), daemon=True)
    thread.start()
    assert started.wait(10)
    try:
        yield server.port, tenant
    finally:
        loop.call_soon_threadsafe(
            lambda: server._server is not None and server._server.close())
        loop.call_soon_threadsafe(loop.stop)
        thread.join(10)
        assert not thread.is_alive()
