"""The build's report readers (``ops/_build.py``): the names of the chain
kernel's instantiations, ptxas's registers and spills from a library's build
log, the faults phase 0 of ``chip_smoke.py`` refuses in them (a spill, or
more registers than the launch bound), and the count of an instruction in a
library's SASS, which phase 6 checks (tensor-core products, HMMA); here they
read fixed texts on the CPU, the SASS through a stand-in for the toolkit's
``cuobjdump``."""

import os
import stat

import pytest

from montecarlopredictivecoding_tpu_torch.ops import _build

BF16_18 = "_ZN4mcpc17mcpc_chain_kernelILi9ELb0ELi0ELb1ELi0EEEvNS_9ChainArgsE"
F32_TANH_2 = "_ZN4mcpc17mcpc_chain_kernelILi1ELb1ELi1ELb0ELi1EEEvNS_9ChainArgsE"
SUM_F4 = ("_ZN46_GLOBAL__N__8d5eb5e4_13_mcpc_chain_cu_759120a719sum_partials_kernel"
          "I6float4EEvPKT_PS2_im")

LOG = f"""nvcc took 41.9 s
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{SUM_F4}' for 'sm_90a'
ptxas info    : Function properties for {SUM_F4}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 92 registers, used 0 barriers
ptxas info    : Compiling entry function '{BF16_18}' for 'sm_90a'
ptxas info    : Function properties for {BF16_18}
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 227 registers, used 1 barriers, 128 bytes smem
ptxas info    : Compiling entry function '{F32_TANH_2}' for 'sm_90a'
ptxas info    : Function properties for {F32_TANH_2}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 216 registers, used 1 barriers, 128 bytes smem
"""

SASS = f"""
	code for sm_90a
		Function : {BF16_18}
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;            /* 0x00000a00ff017b82 */
                                                                     /* 0x000fe40000000800 */
        /*0010*/                   HMMA.16816.F32.BF16 R72, R52, R84, R72 ;   /* 0x000000545248723c */
                                                                     /* 0x000fe20000041848 */
        /*0020*/              @!P5 HMMA.1688.F32.BF16 R4, R8, R12, R4 ;    /* 0x0000000c0804723c */
                                                                     /* 0x000fe20000041804 */
		Function : {F32_TANH_2}
        /*0000*/                   FFMA R1, R2, R3, R1 ;             /* 0x0000000302017223 */
                                                                     /* 0x000fe20000000001 */
        /*0010*/                   EXIT ;                            /* 0x000000000000794d */
"""


def test_kernel_names_spell_out_the_template_arguments():
    assert _build.kernel_name(BF16_18) == (
        "mcpc_chain_kernel<rows 18, plain, relu, bf16, packed>")
    assert _build.kernel_name(F32_TANH_2) == (
        "mcpc_chain_kernel<rows 2, OPT, tanh, f32, unpacked>")
    assert _build.kernel_name(SUM_F4) == "sum_partials_kernel<float4>"
    assert _build.kernel_name("_Z5otherv") == "_Z5otherv"
    assert (_build.kernel_name("_ZN12_GLOBAL__N_121inception_conv_kernelILi96ELi2EEEvNS_4ConvE")
            == "inception_conv_kernel<128 x 96>")


def test_ptxas_resources_reads_registers_and_spills(tmp_path):
    library = tmp_path / "lib.so"
    (tmp_path / "lib.so.log").write_text(LOG)
    assert _build.ptxas_resources(library) == {
        "sum_partials_kernel<float4>": (92, 0, 0),
        "mcpc_chain_kernel<rows 18, plain, relu, bf16, packed>": (227, 12, 16),
        "mcpc_chain_kernel<rows 2, OPT, tanh, f32, unpacked>": (216, 0, 0),
    }


@pytest.mark.parametrize("threads,cap", [(256, 255), (384, 168), (512, 128)])
def test_launch_bound_registers(threads, cap):
    assert _build.launch_bound_registers(threads) == cap


def test_resource_faults_refuse_a_spill_and_registers_over_the_bound(tmp_path):
    library = tmp_path / "lib.so"
    (tmp_path / "lib.so.log").write_text(LOG)
    resources = _build.ptxas_resources(library)
    # the bf16 kernel of the log spills: phase 0 fails on it
    assert _build.resource_faults(resources, 256) == [
        "mcpc_chain_kernel<rows 18, plain, relu, bf16, packed>: spills (12 B stored, "
        "16 B loaded)"]
    # at 512 threads a block both kernels hold more than 128 registers; the
    # summing pass is not a chain kernel and is not held
    faults = _build.resource_faults(resources, 512)
    assert len(faults) == 3
    assert sum("over the 128 of 512 threads" in f for f in faults) == 2
    # without the spill, the report passes at 256 threads
    clean = tmp_path / "clean.so"
    (tmp_path / "clean.so.log").write_text(LOG.replace(
        "12 bytes spill stores, 16 bytes spill loads", "0 bytes spill stores, 0 bytes spill loads"))
    assert _build.resource_faults(_build.ptxas_resources(clean), 256) == []


@pytest.mark.parametrize("opcode,want", [("HMMA", (2, 0)), ("FFMA", (0, 1)),
                                         ("HMM", (0, 0)),
                                         # one form of the instruction, spelled out
                                         ("HMMA.16816.F32.BF16", (1, 0)),
                                         ("HMMA.1688.F32.BF16", (1, 0)),
                                         ("HMMA.1688.F32.TF32", (0, 0))])
def test_sass_counts_counts_an_instruction_per_function(tmp_path, monkeypatch, opcode, want):
    sass = tmp_path / "dump.txt"
    sass.write_text(SASS)
    tool = tmp_path / "cuobjdump"   # prints the dump whatever the library
    tool.write_text(f"#!/bin/sh\ncat '{sass}'\n")
    tool.chmod(tool.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "nvcc_path", lambda: os.path.join(str(tmp_path), "nvcc"))
    assert _build.sass_counts(tmp_path / "lib.so", opcode) == {
        BF16_18: want[0], F32_TANH_2: want[1]}
