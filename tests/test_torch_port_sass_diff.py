"""PyTorch port: `tools/sass_diff.py`, which compares the machine code of
the kernels of two `csrc` trees function by function. Building and
disassembling need the CUDA toolkit; what the CPU can check is the reading
of `cuobjdump -sass` output and the comparison."""

import pytest

from yolou_tpu_torch.tools import sass_diff

from .torch_threads import one_torch_thread  # noqa: F401


def _listing(namespace, kernels, control="0x000fe20000000000"):
    """`cuobjdump -sass`'s layout: a header, then per function its name line
    and instruction lines, each with an address and the first word of its
    encoding, the second word (`control`) on a line of its own."""
    lines = ["", "Fatbin elf code:", "================", "arch = sm_90a"]
    for name, instructions in kernels.items():
        lines += ["", f"        Function : _ZN46_GLOBAL__N__{namespace}"
                      f"_13_a2c2f_bf16_cu_e655882f{name}Ev",
                  "        .headerflags    @\"EF_CUDA_SM90\""]
        for i, ins in enumerate(instructions):
            lines += [f"        /*{16 * i:04x}*/                   {ins} ;"
                      f"    /* 0x000fc40000000f00 */",
                      "                                    "
                      f"  /* {control} */"]
    return "\n".join(lines)


@pytest.mark.parametrize("changed", [False, "instruction", "control"])
def test_sass_listings_compare_by_function(changed):
    old = sass_diff.functions(_listing("2fd6025f", {
        "6kernelA": ["MOV R1, c[0x0][0x28]", "EXIT"],
        "6kernelB": ["MOV R1, c[0x0][0x28]", "FFMA R2, R3, R4, R5", "EXIT"],
        "6kernelC": ["EXIT"]}))
    new = sass_diff.functions(_listing("dc9354bb", {
        "6kernelA": ["MOV R1, c[0x0][0x28]", "EXIT"],
        "6kernelB": ["MOV R1, c[0x0][0x28]",
                     "FFMA R2, R3, R4, R6" if changed == "instruction"
                     else "FFMA R2, R3, R4, R5", "EXIT"],
        "6kernelD": ["NOP", "EXIT"]},
        "0x000fe40000000000" if changed == "control" else "0x000fe20000000000"))
    # the anonymous namespace's per-file hash and the addresses are not
    # part of a function's identity; each instruction and both words of its
    # encoding are (a changed control word changes every function)
    assert len(old) == len(new) == 3
    assert all(len(v) == n for v, n in zip(old.values(), (2, 3, 1)))
    name = "_ZN46_GLOBAL__N__13_a2c2f_bf16_cu_e655882f{}Ev".format
    result = sass_diff.compare(old, new)
    assert result["new"] == [name("6kernelD")]
    assert result["gone"] == [name("6kernelC")]
    if changed == "control":
        assert result["identical"] == []
        assert result["differ"] == [(name("6kernelA"), 2, 2),
                                    (name("6kernelB"), 3, 3)]
    elif changed:
        assert result["identical"] == [name("6kernelA")]
        assert result["differ"] == [(name("6kernelB"), 3, 3)]
    else:
        assert result["identical"] == [name("6kernelA"), name("6kernelB")]
        assert result["differ"] == []
