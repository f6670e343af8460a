"""The CUDA build's reports, read on the CPU: ptxas's registers, spills
and shared memory per kernel, the SASS instruction count that shows a
kernel runs on the tensor cores (both parsed by ``chip_smoke.py``), and the
wrappers' checks that run before any launch (alignment, device)."""

import importlib.util
import pathlib

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.gc_compact import kernel as gc_kernel
from repro_torch.kernels.gc_one import kernel as gc_one_kernel
from repro_torch.kernels.paged_attention import kernel as paged_kernel

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

FLASH = "_ZN12_GLOBAL__N_117flash_bf16_kernelILi128ELi2EEEvPK13__nv_bfloat16"
PAGED = "_ZN12_GLOBAL__N_122paged_attention_kernelIfLi8EEEvPKT_"

PTXAS_LOG = f"""\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{FLASH}' for 'sm_90a'
ptxas info    : Function properties for {FLASH}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 208 registers, used 0 barriers, 408 bytes cmem[0]
ptxas info    : Compiling entry function '{PAGED}' for 'sm_90a'
ptxas info    : Function properties for {PAGED}
    32 bytes stack frame, 48 bytes spill stores, 44 bytes spill loads
ptxas info    : Used 128 registers, 1024 bytes smem, 400 bytes cmem[0]
"""

SASS = f"""\
\tcode for sm_90a
\t\tFunction : {FLASH}
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0100*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0110*/                   HMMA.16816.F32.BF16 R16, R8, R14, R16 ;
\t\tFunction : {PAGED}
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   FFMA R2, R3, R4, R2 ;
"""


def test_parse_ptxas_reads_every_kernel():
    report = chip_smoke.parse_ptxas(PTXAS_LOG)
    assert report == {
        FLASH: {"stack": 0, "spill_stores": 0, "spill_loads": 0,
                "registers": 208, "static_smem": 0},
        PAGED: {"stack": 32, "spill_stores": 48, "spill_loads": 44,
                "registers": 128, "static_smem": 1024},
    }


def test_count_opcode_counts_by_function():
    assert chip_smoke.count_opcode(SASS, "HMMA") == {FLASH: 2, PAGED: 0}
    assert chip_smoke.count_opcode(SASS, "FFMA") == {FLASH: 0, PAGED: 1}


def test_check_aligned_refuses_a_misaligned_view():
    x = torch.zeros(64, dtype=torch.bfloat16)
    _build.check_aligned("op", x=x[8:])  # 16 bytes in
    with pytest.raises(ValueError, match="16-byte aligned"):
        _build.check_aligned("op", x=x[1:])


@pytest.mark.parametrize("d", [32, 64, 128])
def test_cuda_wrappers_refuse_cpu_tensors(d):
    """On the CPU the ops run their plain versions; the kernels' wrappers
    raise rather than launch or fall back."""
    q = torch.zeros((1, 4, d))
    pool = torch.zeros((2, 8, 2, d))
    rest = (torch.zeros((1, 2), dtype=torch.int32),
            torch.ones(1, dtype=torch.int32),
            torch.ones((1, 2, 8), dtype=torch.int8))
    with pytest.raises(ValueError, match="tensors on cpu"):
        paged_kernel.paged_attention_cuda(q, pool, pool, *rest)
    qf = torch.zeros((1, 16, 4, d))
    kv = torch.zeros((1, 16, 2, d))
    with pytest.raises(ValueError, match="tensors on cpu"):
        flash_kernel.flash_attention_cuda(qf, kv, kv)
    pools = torch.zeros((2, 4, 8, 2, d))
    with pytest.raises(ValueError, match="tensors on cpu"):
        gc_kernel.gc_compact_cuda(pools, pools, torch.tensor(
            [[0, 1, 2, 3]], dtype=torch.int32))


def test_gc_one_is_built_and_bound():
    """The GC kernel's source is one of the build's, its launcher takes the
    packed pointers and sizes, and its pointer order is the source's."""
    symbol, argtypes = _build.SIGNATURES["gc_one"]
    assert symbol == "gc_one_launch" and len(argtypes) == 8
    text = (_build.CSRC / "gc_one.cu").read_text()
    struct = text[text.index("struct Ptrs {"):text.index("};", text.index(
        "struct Ptrs {"))]
    fields = [line.split("*")[1].split(";")[0].strip()
              for line in struct.splitlines()[1:] if "*" in line]
    assert tuple(fields) == gc_one_kernel.ORDER
    assert gc_one_kernel.MODES == ("gc", "valve", "movement")


@pytest.mark.parametrize("mangled,short", [
    (FLASH, "flash_bf16_kernel<128, 2>"),
    (PAGED, "paged_attention_kernel<fp32, 8>"),
    ("_ZN12_GLOBAL__N_122paged_attention_kernelI13__nv_bfloat16Li2EEEvPKT_",
     "paged_attention_kernel<bf16, 2>"),
    ("_ZN12_GLOBAL__N_117flash_fp32_kernelILi64EEEvPKfS2_S2_Pf",
     "flash_fp32_kernel<64>"),
    ("_ZN45_GLOBAL__N__b905c18f_12_write_run_cu_f38e313b16write_run_kernelILi"
     "2ELb1ELb0EEEvNS_4PtrsENS_4DimsE", "write_run_kernel<2, 1, 0>"),
    ("_ZN41_GLOBAL__N__7ffd6287_9_gc_one_cu_f9d0c98213gc_one_kernelILi1ELb1EEE"
     "vNS_4PtrsENS_4DimsE", "gc_one_kernel<1, 1>"),
    ("_ZN46_GLOBAL__N__cc20e2c0_13_gc_compact_cu_afd97ce317gc_compact_kernelIL"
     "b0EEEvP5uint4S2_PKiS2_iiiiii", "gc_compact_kernel<0>"),
])
def test_short_name_reads_template_arguments(mangled, short):
    assert chip_smoke.short_name(mangled) == short
