from .kernel import ssd_scan
from .ops import ssd
from .ref import ssd_chunked, ssd_ref

__all__ = ["ssd_scan", "ssd", "ssd_chunked", "ssd_ref"]
