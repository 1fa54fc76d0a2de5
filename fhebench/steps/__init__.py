"""The operations a traffic mix's requests are made of, one module an
operation: fhebench/steps/<scheme>/<op>.py issues the port's calls, and
fhebench/reference/steps/<scheme>/<op>.py says in plain terms what they
should give.  A scheme's generator finds both by the names in the traffic
file, so a new operation is two new files."""

import importlib
import re

NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def load(scheme: str, op: str):
    """The module of operation `op` of `scheme`."""
    if not (NAME.match(scheme) and NAME.match(op)):
        raise ValueError(f"not a module name: {scheme!r}, {op!r}")
    return importlib.import_module(f"{__name__}.{scheme}.{op}")
