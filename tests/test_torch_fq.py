"""The port's three field ops (plain PyTorch versions and wrappers) against the
JAX package's plane ops and Python ints, exactly.

The JAX side runs as its own tests run it on the CPU: ``add_mod``/``sub_mod``
through the Pallas kernels in interpret mode on one ``(32, 8, 128)`` tile.
``mul_mod`` goes through the reference's CPU plane path
(``make_plane_ops(interpret=True)``, the einsum/Barrett delegation), because
the Pallas multiply in interpret mode takes minutes per tile on a CPU.

The CUDA kernels run only on the card: ``chip_smoke.py`` holds each against
its plain version there, and the ``cuda``-marked test below does the same
where a card is present.
"""

import random
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lambda_ethereum_consensus_tpu.crypto.bls.fields import P
from lambda_ethereum_consensus_tpu.ops import bigint as JBI
from lambda_ethereum_consensus_tpu.ops import bigint_pallas as JBP
from lambda_ethereum_consensus_tpu_torch import convert
from lambda_ethereum_consensus_tpu_torch.ops import bigint as BI
from lambda_ethereum_consensus_tpu_torch.ops import bigint_pallas as BP

ROOT = Path(__file__).resolve().parent.parent
_CU = ROOT / "lambda_ethereum_consensus_tpu_torch" / "csrc" / "fq.cu"
KERNELS = ("mul_mod", "add_mod", "sub_mod")
HOST = {
    "mul_mod": lambda x, y: x * y % P,
    "add_mod": lambda x, y: (x + y) % P,
    "sub_mod": lambda x, y: (x - y) % P,
}
EDGES = [0, 1, P - 1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # the plain versions issue many small tensor ops; extra threads only
    # contend with the other test workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _values(n: int, seed: int, edges_first: bool = True) -> list[int]:
    rng = random.Random(seed)
    xs = [rng.randrange(P) for _ in range(n)]
    if edges_first:
        xs[: len(EDGES)] = EDGES
    else:
        xs[-len(EDGES):] = EDGES
    return xs


def _tile_pair():
    """One (32, 8, 128) tile of operands; edge values meet each other and
    random values at both ends."""
    xs = _values(1024, 11)
    ys = _values(1024, 12, edges_first=False)
    ys[:9] = [e for e in EDGES for _ in EDGES]
    xs[:9] = [e for _ in EDGES for e in EDGES]
    return xs, ys


@pytest.fixture(scope="module")
def jax_ops():
    return {
        "pallas": JBP.make_plane_ops(pallas_interpret=True),
        "plane": JBP.make_plane_ops(interpret=True),
    }


@pytest.mark.parametrize("name", KERNELS)
def test_plain_matches_jax_on_a_tile(name, jax_ops):
    import jax.numpy as jnp

    xs, ys = _tile_pair()
    a, b = BP.to_planes(xs).reshape(32, 8, 128), BP.to_planes(ys).reshape(32, 8, 128)
    route = "plane" if name == "mul_mod" else "pallas"
    want = np.asarray(jax_ops[route][name](jnp.asarray(a), jnp.asarray(b)))
    got = getattr(BP, name)(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and tuple(got.shape) == (32, 8, 128)
    assert np.array_equal(got.numpy(), want)
    assert BP.from_planes(want) == [HOST[name](x, y) for x, y in zip(xs, ys)]


@pytest.mark.parametrize("name", KERNELS)
def test_plain_matches_python_ints(name):
    xs, ys = _values(600, 21), _values(600, 22, edges_first=False)
    # values just below p and products near multiples of p
    rng = random.Random(23)
    xs += [P - 1 - rng.randrange(1 << 40) for _ in range(100)]
    ys += [P - 1 - rng.randrange(1 << 20) for _ in range(100)]
    got = getattr(BP, name)(torch.from_numpy(BP.to_planes(xs)), torch.from_numpy(BP.to_planes(ys)))
    assert BP.from_planes(got.numpy()) == [HOST[name](x, y) for x, y in zip(xs, ys)]


@pytest.mark.parametrize("name", KERNELS)
def test_broadcast_constant_operand(name, jax_ops):
    import jax.numpy as jnp

    xs = _values(64, 31)
    c = random.Random(32).randrange(P)
    a = BP.to_planes(xs)
    const = BI.to_limbs(c)[:, None]  # (32, 1) broadcasts over the batch
    got = getattr(BP, name)(torch.from_numpy(a), torch.from_numpy(const))
    assert BP.from_planes(got.numpy()) == [HOST[name](x, c) for x in xs]
    want = jax_ops["plane"][name](jnp.asarray(a), jnp.asarray(const))
    assert np.array_equal(got.numpy(), np.asarray(want))
    flipped = getattr(BP, name)(torch.from_numpy(const), torch.from_numpy(a))
    assert BP.from_planes(flipped.numpy()) == [HOST[name](c, x) for x in xs]


@pytest.mark.parametrize("name", KERNELS)
def test_component_axes_flatten_into_the_batch(name, jax_ops):
    import jax.numpy as jnp

    xs, ys = _values(2 * 3 * 5, 41), _values(2 * 3 * 5, 42, edges_first=False)
    a = BP.to_planes(xs).reshape(32, 2, 3, 5)
    b = BP.to_planes(ys).reshape(32, 2, 3, 5)
    got = getattr(BP, name)(torch.from_numpy(a), torch.from_numpy(b[:, :, :, :1]))
    want = jax_ops["plane"][name](jnp.asarray(a), jnp.asarray(b[:, :, :, :1]))
    assert tuple(got.shape) == (32, 2, 3, 5)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_to_and_from_planes_match_jax():
    xs = _values(300, 51)
    assert np.array_equal(BP.to_planes(xs), JBP.to_planes(xs, 3).reshape(32, -1)[:, :300])
    assert BP.from_planes(BP.to_planes(xs)) == xs == JBP.from_planes(JBP.to_planes(xs, 3), 300)
    assert BI.MU == JBI.MU and np.array_equal(BI.to_limbs(P), JBI.to_limbs(P))


def test_convert_planes_round_trip():
    arr = BP.to_planes(_values(12, 61)).reshape(32, 2, 3, 2)
    t = convert.planes_to_torch(arr, device="cpu")
    assert t.dtype == torch.int32 and tuple(t.shape) == (32, 2, 3, 2)
    back = convert.planes_from_torch(t)
    assert back.dtype == np.int32 and np.array_equal(back, arr)
    with pytest.raises(ValueError):
        convert.planes_to_torch(np.zeros((31, 4), np.int32), device="cpu")


def _cu_words(name: str) -> list[int]:
    m = re.search(rf"__constant__ \w+ {name}\[(\d+)\] = \{{(.*?)\}};", _CU.read_text(), re.S)
    assert m, f"{name} not found in {_CU.name}"
    values = [int(v, 16) for v in re.findall(r"0x[0-9A-Fa-f]+", m.group(2))]
    assert len(values) == int(m.group(1))
    return values


def _cu_int(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", _CU.read_text())
    assert m, f"{name} not found in {_CU.name}"
    return int(m.group(1))


def test_cuda_constants_match_python():
    assert _cu_words("kP12") == [int(v) for v in BI.to_limbs(P)]
    assert _cu_words("kPw") == [(P >> (32 * i)) & 0xFFFFFFFF for i in range(12)]
    mu = (1 << 768) // P
    assert _cu_words("kMu") == [(mu >> (32 * i)) & 0xFFFFFFFF for i in range(13)]
    # the launch geometry the wrapper computes must suit the kernels
    assert _cu_int("kMulGroup") == BP.MUL_GROUP and 32 % BP.MUL_GROUP == 0
    assert _cu_int("kLimbs") % BP.MUL_GROUP == 0  # each rank stores whole limbs
    assert (_cu_int("kLimbs"), _cu_int("kLimbBits"), _cu_int("kWords")) == (32, 12, 12)
    for threads in BP.BLOCK_THREADS.values():
        assert threads % 32 == 0 and threads <= _cu_int("kMaxThreads")


@pytest.mark.parametrize(
    "a,b",
    [
        (torch.zeros((32, 4), dtype=torch.int64), torch.zeros((32, 4), dtype=torch.int32)),
        (torch.zeros((31, 4), dtype=torch.int32), torch.zeros((31, 4), dtype=torch.int32)),
        (torch.zeros((32, 4), dtype=torch.int32), torch.zeros((32, 2, 4), dtype=torch.int32)),
        (torch.zeros(32, dtype=torch.int32), torch.zeros((32, 4), dtype=torch.int32)),
    ],
    ids=["int64", "31-limbs", "rank-mismatch", "rank1"],
)
@pytest.mark.parametrize("name", KERNELS)
def test_wrapper_rejects_bad_input(name, a, b):
    launches = dict(BP.kernel_launches)
    with pytest.raises(ValueError):
        getattr(BP, name)(a, b)
    assert BP.kernel_launches == launches


def test_cpu_path_counts_no_launch():
    launches = dict(BP.kernel_launches)
    a = torch.from_numpy(BP.to_planes(_values(4, 71)))
    for name in KERNELS:
        getattr(BP, name)(a, a)
    assert BP.kernel_launches == launches


def test_port_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import lambda_ethereum_consensus_tpu_torch.crypto.bls.batch\n"
        "import lambda_ethereum_consensus_tpu_torch.ops.bls_batch\n"
        "import lambda_ethereum_consensus_tpu_torch.convert\n"
        "bad = [m for m in sys.modules if m.startswith('lambda_ethereum_consensus_tpu.')"
        " or m == 'lambda_ethereum_consensus_tpu']\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, timeout=120)


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; chip_smoke.py runs this check on the card")
    # the tile, and lane counts on both sides of mul_mod's group threshold
    t = BP.MUL_GROUP_THRESHOLD
    for n in (1024, t - 1, t + 1):
        xs, ys = _values(n, 81 + n), _values(n, 82 + n, edges_first=False)
        if n == 1024:
            xs, ys = _tile_pair()
        a = torch.from_numpy(BP.to_planes(xs)).cuda()
        b = torch.from_numpy(BP.to_planes(ys)).cuda()
        const = torch.from_numpy(BI.to_limbs(7)[:, None]).cuda()
        for name in KERNELS:
            for lhs, rhs in ((a, b), (a, const), (const, a)):
                before = BP.kernel_launches[name]
                got = getattr(BP, name)(lhs, rhs)
                torch.cuda.synchronize()
                assert BP.kernel_launches[name] == before + 1
                assert torch.equal(got, BP._PLAIN[name](lhs, rhs))
