"""The name reader of ``repro_torch.kernels._launches``, on the CPU.

``launched_kernels`` itself needs a card (tests/test_torch_gpu.py); the
names it reports come from ``function_name``, held here to symbols of the
port's own kernels as nvcc mangles them."""
import pytest

from repro_torch.kernels._launches import function_name

_SSD = "_ZN42_GLOBAL__N__95661dc2_10_ssd_fwd_cu_ssd_fwd"
_FLASH = "_ZN45_GLOBAL__N__e8bf1b56_12_flash_fwd_cu_b294bfd0"


@pytest.mark.parametrize("mangled,name", [
    (_SSD + "12ssd_chunk_cbILi128EEEvNS_6ParamsE", "ssd_chunk_cb"),
    (_SSD + "15ssd_chunk_stateILi64ELi128EEEvNS_6ParamsE", "ssd_chunk_state"),
    (_SSD + "17ssd_state_passingENS_6ParamsE", "ssd_state_passing"),
    (_SSD + "14ssd_chunk_scanILi16ELi16EEEvNS_6ParamsE", "ssd_chunk_scan"),
    (_SSD + "12ssd_fwd_fp32ILi8ELi8EEEvNS_6ParamsE", "ssd_fwd_fp32"),
    (_FLASH + "21flash_fwd_prefill_mmaILi64ELi1EEEvNS_6ParamsE",
     "flash_fwd_prefill_mma"),
    ("_Z6kernelPf", "kernel"),                  # at namespace scope
    ("ssd_fwd", "ssd_fwd"),                     # extern "C": as it is
])
def test_function_name_reads_the_kernel_name(mangled, name):
    assert function_name(mangled) == name
