"""The program under test, one module a configuration's ``system``: each
builds it from the configuration's file and the seed, hands it the
requests, and judges what it answered against the plain reference of the
configuration's ``family`` (``bench/reference/<family>.py``), which also
gives the parameter layout and the FLOPs."""
import importlib
from types import ModuleType


def family(cfg: dict) -> ModuleType:
    """The plain reference module that ``cfg`` names by ``family``."""
    return importlib.import_module(f"bench.reference.{cfg['family']}")
