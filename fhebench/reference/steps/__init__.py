"""What each operation of a traffic mix gives, in plain terms, one module an
operation: steps/<scheme>/<op>.py beside fhebench/steps/<scheme>/<op>.py."""

import importlib
import re

NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def load(scheme: str, op: str):
    """The plain module of operation `op` of `scheme`."""
    if not (NAME.match(scheme) and NAME.match(op)):
        raise ValueError(f"not a module name: {scheme!r}, {op!r}")
    return importlib.import_module(f"{__name__}.{scheme}.{op}")
