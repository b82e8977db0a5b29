from .kernel import ssd_scan, ssd_scan_bwd
from .ops import ssd
from .ref import ssd_chunked, ssd_chunked_bwd, ssd_ref

__all__ = ["ssd_scan", "ssd_scan_bwd", "ssd", "ssd_chunked",
           "ssd_chunked_bwd", "ssd_ref"]
