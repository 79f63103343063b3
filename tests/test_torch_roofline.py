"""``roofline/analysis.py::roofline_report`` and ``RooflineReport``
against the JAX package's.

The reference parses per-opcode collective bytes out of HLO text
(``collective_bytes_from_hlo``); the port takes them as a mapping (its dry
run counts them, ``runtime/sharding.py::Traffic.per_op``).  Each case
writes HLO lines for the reference, whose parse gives the mapping the port
is handed, with the same per-device FLOPs and bytes.  The global counts
(``hlo_flops``, ``hlo_bytes``, ``collective_bytes``, ``model_flops``,
``useful_flops_ratio``) and the per-opcode bytes must be the reference's
exactly; the three terms are the reference's scaled by the ratio of the
constants (H100 SXM: 989e12 FLOP/s, 3.35e12 B/s, 40e9 B/s between NVLink
islands; the reference's TPU v5e: 197e12, 819e9, 50e9), to 1e-12
relative; the bottleneck is the largest of the port's own terms.
"""
import pytest

from repro.roofline import analysis as ref
from repro_torch.roofline import (HBM_BW, LINK_BW, PEAK_FLOPS,
                                  RooflineReport, roofline_report)

HLO = {
    "all-gather": "%all-gather.1 = bf16[16,512,128]{2,1,0} all-gather("
                  "%p), dimensions={0}",
    "all-reduce": "%all-reduce.2 = f32[1024,64]{1,0} all-reduce(%q)",
    "reduce-scatter": "%reduce-scatter.3 = bf16[64,128]{1,0} "
                      "reduce-scatter(%r), dimensions={0}",
    "all-to-all": "%all-to-all.4 = bf16[8,256,32]{2,1,0} all-to-all(%s)",
    "collective-permute": "%collective-permute-start.5 = bf16[4,4096]{1,0} "
                          "collective-permute-start(%t)",
}

# (per-device flops, per-device bytes, opcodes present, repeats, chips,
#  model flops): the port's terms make each bottleneck at least once
CASES = [
    (5e14, 1e9, ("all-gather",), 1, 256, 1e17),
    (1e12, 8e11, ("all-reduce", "reduce-scatter"), 2, 256, 1e14),
    (1e12, 1e9, tuple(HLO), 3000, 512, 0.0),
    (0.0, 0.0, (), 0, 8, 0.0),
]


def _hlo(ops, repeats):
    return "\n".join(HLO[op] for op in ops for _ in range(repeats))


@pytest.mark.parametrize("case", range(len(CASES)))
def test_roofline_report_against_the_reference(case):
    flops, nbytes, ops, reps, chips, mf = CASES[case]
    cost = {"flops": flops, "bytes accessed": nbytes}
    text = _hlo(ops, reps)
    want = ref.roofline_report(arch="a", shape="s", mesh_name="m",
                               chips=chips, cost_analysis=cost,
                               hlo_text=text, model_flops_global=mf)
    colls = ref.collective_bytes_from_hlo(text)
    got = roofline_report(arch="a", shape="s", mesh_name="m", chips=chips,
                          cost_analysis=cost, collectives=colls,
                          model_flops_global=mf)
    assert isinstance(got, RooflineReport)
    for k in ("arch", "shape", "mesh", "chips", "hlo_flops", "hlo_bytes",
              "collective_bytes", "model_flops", "per_op_collectives"):
        assert getattr(got, k) == getattr(want, k), k
    assert got.useful_flops_ratio == want.useful_flops_ratio
    assert got.t_compute == pytest.approx(
        want.t_compute * ref.PEAK_FLOPS / PEAK_FLOPS, rel=1e-12, abs=0)
    assert got.t_memory == pytest.approx(
        want.t_memory * ref.HBM_BW / HBM_BW, rel=1e-12, abs=0)
    assert got.t_collective == pytest.approx(
        want.t_collective * ref.LINK_BW / LINK_BW, rel=1e-12, abs=0)
    terms = {"compute": flops / PEAK_FLOPS, "memory": nbytes / HBM_BW,
             "collective": sum(colls.values()) / LINK_BW}
    assert got.bottleneck == max(terms, key=terms.get)
    assert list(got.row()) == list(want.row())
    assert got.row()["bottleneck"] == got.bottleneck


def test_constants_are_the_h100_cluster():
    from repro_torch.core.hardware import h100_cluster
    assert (PEAK_FLOPS, HBM_BW) == (989e12, 3.35e12)
    assert LINK_BW == h100_cluster(256).inter_island_bandwidth == 40e9


def test_each_bottleneck_occurs():
    seen = set()
    for flops, nbytes, ops, reps, chips, mf in CASES[:3]:
        colls = ref.collective_bytes_from_hlo(_hlo(ops, reps))
        seen.add(roofline_report(
            arch="a", shape="s", mesh_name="m", chips=chips,
            cost_analysis={"flops": flops, "bytes accessed": nbytes},
            collectives=colls, model_flops_global=mf).bottleneck)
    assert seen == {"compute", "memory", "collective"}
