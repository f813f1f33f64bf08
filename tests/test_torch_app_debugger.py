"""The ``TestDebuggerDriver`` cases of the reference's
``tests/test_debugger_monitor.py`` run against the port: the debugger
driver and the debug tool stepping recorded goldens, each case with the
reference's own assertions (``torch_reference``). The monitor half of
that file runs in ``tests/test_torch_monitor.py``."""

from torch_reference import port_reference

_ported: dict = {"__name__": __name__, "__file__": __file__}
port_reference("test_debugger_monitor", _ported)
TestDebuggerDriver = _ported["TestDebuggerDriver"]
