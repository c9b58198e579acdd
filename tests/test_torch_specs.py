"""The port's ``KernelSpec``, ``DeviceProfile`` and Hadoop byte model against
the reference's.

Pure arithmetic on both sides, so every comparison is exact: the same
validation errors for the same bad specs, the same tile shapes, and the
same byte and second counts for the arguments of ``tests/test_io_model.py``.
The profile's budget on the CPU is the H100 row, so the feasibility guards
make the decisions they made with the old fixed budget.
"""
import dataclasses

import pytest
import torch

from repro.core import io_model as jio
from repro.kernels import specs as jspecs
from repro.kernels import tuning as jtuning
from repro_torch.core import io_model
from repro_torch.kernels import batch_resident, centroid_update, specs

SHAPES = [(64, 2, 3), (300, 2, 5), (1000, 17, 7), (513, 64, 130),
          (2048, 128, 256), (96, 160, 9), (5, 3, 1)]
GEOMETRIES = [dict(), dict(block_n=64, block_k=64),
              dict(block_n=512, block_k=256, acc_dtype="bfloat16"),
              dict(block_n=1024, block_k=512)]
BAD = [dict(block_n=7), dict(block_n=0), dict(block_k=100), dict(block_k=-8),
       dict(acc_dtype="int8"), dict(acc_dtype="f32"), dict(block_n=8.0),
       dict(group_t=0), dict(group_t=1.5)]


@pytest.mark.parametrize("bad", BAD, ids=[str(b) for b in BAD])
def test_spec_validation_matches_reference(bad):
    with pytest.raises(ValueError) as want:
        jspecs.KernelSpec(**bad)
    with pytest.raises(ValueError) as got:
        specs.KernelSpec(**bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("geom", GEOMETRIES, ids=[str(g) for g in GEOMETRIES])
def test_tile_shapes_match_reference(geom):
    ours, theirs = specs.KernelSpec(**geom), jspecs.KernelSpec(**geom)
    assert hash(ours) == hash(specs.KernelSpec(**geom))
    assert ours.acc_bytes == theirs.acc_bytes
    assert ours.replace(block_k=128).block_k == 128
    for n, d, k in SHAPES:
        assert ours.tile_shapes(n, d, k) == theirs.tile_shapes(n, d, k)
        assert (ours.update_tile_shapes(n, d, k)
                == theirs.update_tile_shapes(n, d, k))


def test_defaults_and_coerce():
    for name in ("DEFAULT_SPEC", "UPDATE_DEFAULT_SPEC"):
        ours, theirs = getattr(specs, name), getattr(jspecs, name)
        assert (ours.block_n, ours.block_k, ours.acc_dtype, ours.group_t) == (
            theirs.block_n, theirs.block_k, theirs.acc_dtype, theirs.group_t)
    assert specs.coerce(None) is specs.DEFAULT_SPEC
    assert (specs.coerce(None, default=specs.UPDATE_DEFAULT_SPEC)
            is specs.UPDATE_DEFAULT_SPEC)
    bf = specs.KernelSpec(acc_dtype="bfloat16")
    assert specs.coerce(bf) is bf and bf.bf16
    with pytest.raises(TypeError, match="KernelSpec"):
        specs.coerce(256)


@pytest.mark.parametrize("unread", [dict(block_k=64), dict(block_k=256),
                                    dict(group_t=1), dict(group_t=4)],
                         ids=["block_k=64", "block_k=256", "group_t=1",
                              "group_t=4"])
def test_coerce_refuses_fields_no_kernel_reads(unread):
    # the score kernels are built for every block_k of the reference's
    # BLOCK_KS, and only the whole solve reads group_t: these specs pass
    spec = specs.KernelSpec(acc_dtype="bfloat16", **unread)
    jspecs.KernelSpec(acc_dtype="bfloat16", **unread)
    assert specs.BLOCK_KS == jtuning.BLOCK_KS
    for default in (specs.DEFAULT_SPEC, specs.UPDATE_DEFAULT_SPEC):
        assert specs.coerce(spec, default=default) is spec
    # a valid reference spec whose block_k no kernel is built for raises
    for bk in (96, 512):
        odd = spec.replace(block_k=bk)
        jspecs.KernelSpec(acc_dtype="bfloat16", **dict(unread, block_k=bk))
        for default in (specs.DEFAULT_SPEC, specs.UPDATE_DEFAULT_SPEC):
            with pytest.raises(ValueError,
                               match=r"built for block_k in \(64, 128, 256\)"):
                specs.coerce(odd, default=default)
    # block_n is read: any valid one passes
    wide = specs.KernelSpec(block_n=1024, acc_dtype="bfloat16")
    assert specs.coerce(wide) is wide


def test_profile_on_the_cpu_is_the_h100_row():
    prof = specs.get_profile("cpu")
    assert prof is specs.CPU_PROFILE and prof.smem_per_block == 232448
    assert prof.fits(232448) and not prof.fits(232449)
    # the guards' decisions under the H100's budget
    cpu = torch.device("cpu")
    assert batch_resident.batched_feasible(16384, 64, 1024, device=cpu)
    assert not batch_resident.batched_feasible(64, 4, 20000, device=cpu)
    centroid_update.check_k(58112, "the update", cpu)
    with pytest.raises(ValueError, match="shared-memory"):
        centroid_update.check_k(58113, "the update", cpu)


def _io_cases():
    m = dict(m=io_model.HadoopCostModel(), j=jio.HadoopCostModel())
    return {
        "shuffle_sec": [(m, "shuffle_sec", (n,)) for n in
                        (50_000, 500_000, 5_000_000, 3000)],
        "pkmeans": [(m, "pkmeans_bytes", a) for a in
                    ((3000, 2, 5, 10), (3000, 2, 5, 20), (3000, 2, 5, 30),
                     (3000, 2, 5, 6), (3000, 2, 5, 60))],
        "ipkmeans": [(m, "ipkmeans_bytes", (3000, 2, 5, 6, 9)),
                     (m, "ipkmeans_sec", (3000, 2, 5, 6, 9)),
                     (m, "pkmeans_sec", (3000, 2, 5, 30))],
        "tpu": [(None, "tpu_collective_bytes_pkmeans", (2, 5, 100, 256)),
                (None, "tpu_collective_bytes_pkmeans", (2, 5, 10_000, 256)),
                (None, "tpu_collective_bytes_ipkmeans",
                 (3000, 2, 5, 256, 9, 256)),
                (None, "tpu_collective_bytes_ipkmeans",
                 (3000, 2, 5, 256, 9, 512))],
        "dcn": ([(None, "ipkmeans_stats_payload_bytes", (16, 8, d, mode))
                 for d in (2, 16, 32, 64, 256)
                 for mode in ("exact", "int8ef")]
                + [(None, "dcn_reduce_bytes_ipkmeans", (16, 8, 32, it, p, mode))
                   for it, p in ((20, 1), (20, 2), (40, 2))
                   for mode in ("exact", "int8ef")]),
        "s1": [(None, "s1_histogram_dcn_bytes", a) for a in
               ((10, 1), (10, 2), (11, 2), (14, 4), (3, 2))]
        + [(None, "s1_sort_dcn_bytes", a) for a in
           ((1 << 26, 64, 14), (2000, 8, 3), (1000, 8, 3))],
    }


@pytest.mark.parametrize("group", list(_io_cases()))
def test_io_model_matches_reference(group):
    for models, fn, args in _io_cases()[group]:
        if models is None:
            got = getattr(io_model, fn)(*args)
            want = getattr(jio, fn)(*args)
        else:
            got = getattr(models["m"], fn)(*args)
            want = getattr(models["j"], fn)(*args)
        assert got == want, (fn, args)
    if group == "ipkmeans":
        # the ipkmeans byte counts take the tree depth as a keyword too
        got = io_model.HadoopCostModel().ipkmeans_bytes(3000, 2, 5, 6,
                                                        kd_depth=9)
        assert got == jio.HadoopCostModel().ipkmeans_bytes(3000, 2, 5, 6,
                                                           kd_depth=9)
    with pytest.raises(ValueError, match="reduce mode"):
        io_model.ipkmeans_stats_payload_bytes(1, 1, 1, "fp8")
    assert (dataclasses.asdict(io_model.HadoopCostModel())
            == dataclasses.asdict(jio.HadoopCostModel()))
