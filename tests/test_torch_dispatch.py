"""The dispatch-floor probes (suitesparse_tpu_torch/tools/microbench_dispatch
.py) against the reference tool's two Pallas kernels, on the CPU.

tools/microbench_dispatch.py defines its kernels inside ``main()``, so the
two ``pallas_call``s are rebuilt here from the tool's body and run with
``interpret=True``.  The constant 1.0000001 rounds to the float32
1 + 2**-23 in every framework, and each output is one float32 multiply, so
every comparison is exact equality."""
import ctypes
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from suitesparse_tpu_torch.tools import microbench_dispatch as probe
from suitesparse_tpu_torch.utils import cuda_build

ROWS, COLS = probe.ROWS, probe.COLS


def _pally(buf, G):
    """The tool's ``kernel`` / ``pally`` (:69-82), interpreted."""
    def kernel(in_ref, out_ref):
        out_ref[:] = in_ref[:] * 1.0000001

    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct(buf.shape, buf.dtype),
        grid=(G,),
        in_specs=[pl.BlockSpec((512, 128), lambda i: (i, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((512, 128), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        interpret=True,
    )(buf)


def _vm(offs, hbm, G):
    """The tool's ``vmk`` / ``vm`` (:92-119), interpreted."""
    def vmk(offs_ref, hbm_ref, out_ref, scratch, sem):
        i = pl.program_id(0)
        o = offs_ref[i]
        dma = pltpu.make_async_copy(hbm_ref.at[pl.ds(o, 512), :], scratch,
                                    sem)
        dma.start()
        dma.wait()
        scratch[:] = scratch[:] * 1.0000001
        dma2 = pltpu.make_async_copy(scratch, out_ref.at[pl.ds(o, 512), :],
                                     sem)
        dma2.start()
        dma2.wait()

    return pl.pallas_call(
        vmk,
        out_shape=jax.ShapeDtypeStruct(hbm.shape, hbm.dtype),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1,
            grid=(G,),
            in_specs=[pl.BlockSpec(memory_space=pltpu.ANY)],
            out_specs=pl.BlockSpec(memory_space=pltpu.ANY),
            scratch_shapes=[pltpu.VMEM((512, 128), jnp.float32),
                            pltpu.SemaphoreType.DMA(())],
        ),
        compiler_params=pltpu.CompilerParams(has_side_effects=True),
        interpret=True,
    )(offs, hbm)


def _buf(G, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((G * ROWS, COLS)).astype(np.float32)


def test_scale_constant_is_one_plus_ulp():
    assert np.float32(probe.SCALE) == np.float32(1 + 2 ** -23)
    x = torch.tensor([3.0, -1.5, 7e-39], dtype=torch.float32)
    want = x.numpy() * np.float32(1.0000001)
    assert np.array_equal((x * probe.SCALE).numpy(), want)


@pytest.mark.parametrize("G", [1, 4])
def test_scale_blocks_matches_pallas_kernel(G):
    h = _buf(G, G)
    want = np.asarray(_pally(jnp.asarray(h), G))
    got = probe.scale_blocks(torch.from_numpy(h), G)
    plain = probe.scale_blocks_plain(torch.from_numpy(h), G)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(plain.numpy(), want)
    assert np.array_equal(want, h * np.float32(1.0000001))


@pytest.mark.parametrize("G,order", [(1, "reversed"), (4, "reversed"),
                                     (4, "random"), (5, "sparse")])
def test_scale_gather_matches_pallas_vm_kernel(G, order):
    """Bit for bit on the rows the offsets name (the others are left
    unwritten by both)."""
    h = _buf(G, 10 + G)
    rng = np.random.default_rng(7)
    if order == "reversed":
        offs = np.arange(G, dtype=np.int32)[::-1] * ROWS
    elif order == "random":
        offs = rng.permutation(G).astype(np.int32) * ROWS
    else:
        offs = probe.sparse_offsets(rng, G)
    want = np.asarray(_vm(jnp.asarray(offs), jnp.asarray(h), G=len(offs)))
    table = probe.GatherTable(offs, G * ROWS)
    named = table.row_index(torch.device("cpu")).numpy()
    assert order != "sparse" or len(named) < G * ROWS
    got = probe.scale_gather(offs, torch.from_numpy(h))
    plain = probe.scale_gather_plain(table, torch.from_numpy(h))
    assert np.array_equal(got.numpy()[named], want[named])
    assert np.array_equal(plain.numpy()[named], want[named])
    assert np.array_equal(want[named], h[named] * np.float32(1.0000001))


@pytest.mark.parametrize("offs,rows", [
    ([0, 256], 1024),            # windows overlap
    ([512, 512], 1024),          # the same window twice
    ([-512], 1024),              # before the buffer
    ([768], 1024),               # runs past the end
    ([[0, 512]], 1024),          # not one-dimensional
    ([0.0, 512.0], 1024),        # not integers
])
def test_scale_gather_refuses_bad_offsets(offs, rows):
    buf = torch.zeros((rows, COLS), dtype=torch.float32)
    with pytest.raises(ValueError):
        probe.scale_gather(np.asarray(offs), buf)


def test_probes_refuse_bad_buffers():
    with pytest.raises(ValueError):
        probe.scale_blocks(torch.zeros((1000, COLS)), 2)
    with pytest.raises(ValueError):
        probe.scale_blocks(torch.zeros((ROWS, COLS)), 2)
    with pytest.raises(TypeError):
        probe.scale_blocks(torch.zeros((ROWS, COLS), dtype=torch.float64), 1)
    table = probe.GatherTable([0], ROWS)
    with pytest.raises(ValueError):
        probe.scale_gather(table, torch.zeros((2 * ROWS, COLS)))


@pytest.mark.parametrize("K", [1, 64, 256])
def test_eager_chain_matches_jitted_chain(K):
    """XLA folds the K constants into one, 1 + K * 2**-23 (exact in
    float32), and multiplies once; eager PyTorch multiplies K times and
    rounds K times.  So the two are equal at K = 1, and above it agree to
    K half-ulps relative (K * 2**-24); the eager chain equals numpy's K
    sequential float32 multiplies bit for bit."""
    h = np.random.default_rng(K).standard_normal((8, 128)).astype(np.float32)

    @jax.jit
    def chain(x):
        for _ in range(K):
            x = x * 1.0000001
        return x

    want = np.asarray(chain(jnp.asarray(h)))
    assert np.array_equal(want, h * np.float32(1 + K * 2.0 ** -23))
    got = probe.chain(torch.from_numpy(h), K).numpy()
    seq = h.copy()
    for _ in range(K):
        seq = seq * np.float32(1.0000001)
    assert np.array_equal(got, seq)
    if K == 1:
        assert np.array_equal(got, want)
    rel = np.abs(got.astype(np.float64) - want) / np.abs(want)
    assert rel.max() <= K * 2.0 ** -24


def test_probe_main_runs_on_the_cpu(capsys):
    res = probe.main(device="cpu", grids=(1, 2), reps=2)
    lines = capsys.readouterr().out.splitlines()
    heads = [ln.split(":")[0].split(" (")[0] for ln in lines]
    assert heads == ["chain   1", "chain  64", "chain 256",
                     "cholesky W=  1", "trsm     W=  1",
                     "cholesky W= 64", "trsm     W= 64",
                     "kernel G=   1", "kernel G=   2",
                     "gathered G=   1", "gathered G=   2",
                     "launch floor G=   1", "launch route"]
    # no device time and no launch route without a card
    for ln in lines[7:]:
        assert "not measured (cpu)" in ln
    assert "scale_gather" in lines[-2] and "torch.mul" in lines[-2]
    assert res["route"] is None
    assert set(res["kernel"]) == {1, 2} and "device_s" not in res["kernel"][1]
    assert "mul_host_s" in res["kernel"][1]
    # the plain versions ran: no kernel was launched on the CPU
    assert probe.scale_blocks.launches == 0
    assert probe.scale_gather.launches == 0


@pytest.mark.parametrize("entry", sorted(cuda_build.ENTRY_POINTS))
def test_entry_point_signatures_match_the_sources(entry):
    """Every entry point binds each pointer and the stream as c_void_p (an
    int would cut a 64-bit address to 32 bits) and each int as c_int, and
    the table agrees with the extern "C" declaration in its source: the
    leading arguments, then the device index and the stream."""
    lib, kinds = cuda_build.ENTRY_POINTS[entry]
    types = cuda_build.argtypes(entry)
    assert types == [ctypes.c_void_p if k == "p" else ctypes.c_int
                     for k in kinds + "ip"]
    src = (cuda_build.CSRC / f"{lib}.cu").read_text()
    decl = re.search(rf"\bint\s+{entry}\s*\(([^)]*)\)", src)
    params = [" ".join(p.split()) for p in decl.group(1).split(",")]
    for p in params:
        assert "*" in p or re.fullmatch(r"int \w+", p), p
    assert "".join("p" if "*" in p else "i" for p in params) == kinds + "ip"
    assert params[-2:] == ["int dev", "void* stream"]
    assert 'include "launch.cuh"' in src     # sstpu_error_string


def test_launch_refuses_a_cpu_tensor():
    """The launch helper raises for a tensor off the card before it loads
    (or builds) any library."""
    buf = torch.ones((ROWS, COLS))
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_build.launch("sstpu_scale_blocks_f32", buf, buf.data_ptr(),
                          buf.data_ptr(), 1)
    assert "sstpu_scale_blocks_f32" not in cuda_build._bound
