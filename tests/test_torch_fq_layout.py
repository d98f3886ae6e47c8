"""``csrc/fq.cu``'s arithmetic and launch geometry on the CPU, against Python
ints.

The CUDA kernels run only on the card, but everything in ``fq.cu`` above
the kernels is plain C++ when ``__CUDACC__`` is not defined.  A host harness
includes the source as it is, compiled with ``g++``, and drives each
kernel's per-thread body over the launch grid that the wrapper picks
(``bigint_pallas._geometry``): the one-thread bodies thread by thread, and
the group bodies (multiply, add, sub) as one emulated group of ``g`` lanes
at a time, each lane a coroutine run in turns, so that a shuffle or a ballot
writes the lane's register into the group's slots and reads once every lane
has written, as a warp's lanes do in step.  The harness is built once per module
into a temporary directory.
"""

import ctypes
import random
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from lambda_ethereum_consensus_tpu_torch.crypto.bls.fields import P
from lambda_ethereum_consensus_tpu_torch.ops import bigint_pallas as BP

CSRC = Path(__file__).resolve().parent.parent / "lambda_ethereum_consensus_tpu_torch" / "csrc"
GUARD = 64  # int32 words after the output, which no thread may write

_HARNESS = r"""
#include <ucontext.h>
#include <cstdint>
#include <string>
#include <vector>
#include "fq.cu"

namespace {

constexpr int kStack = 1 << 16;

// One emulated group: its lanes run in turns (lane r yields to r + 1, the
// last to lane 0); a shuffle takes two turns, one to write, one to read.
struct Group {
  int size = 1;
  uint32_t slot[8];
  ucontext_t lanes[8], caller;
  std::vector<char> stacks = std::vector<char>(8 * kStack);
  const int32_t *a, *b;
  int64_t als, aes, bls, bes, m, first;
  int32_t* out;
  void turn(int rank) { swapcontext(&lanes[rank], &lanes[(rank + 1) % size]); }
};
Group group;

struct HostLanes {
  int rank;
  uint32_t read(uint32_t v, int from) const {
    group.slot[rank] = v;
    group.turn(rank);
    const uint32_t got = group.slot[from];
    group.turn(rank);
    return got;
  }
  uint32_t shfl(uint32_t v, int r) const { return read(v, r); }
  uint32_t shfl_xor(uint32_t v, int d) const { return read(v, rank ^ d); }
  uint32_t ballot(bool p) const {
    group.slot[rank] = p;
    group.turn(rank);
    uint32_t bits = 0;
    for (int r = 0; r < group.size; ++r) bits |= (group.slot[r] & 1u) << r;
    group.turn(rank);
    return bits;
  }
};

template <int G>
void mul_lane(int rank) {
  mul_thread<G>(HostLanes{rank}, group.first + rank, group.a, group.als, group.aes, group.b,
                group.bls, group.bes, group.out, group.m);
}

template <int G>
void add_lane(int rank) {
  add_thread<G>(HostLanes{rank}, group.first + rank, group.a, group.als, group.aes, group.b,
                group.bls, group.bes, group.out, group.m);
}

template <int G>
void sub_lane(int rank) {
  sub_thread<G>(HostLanes{rank}, group.first + rank, group.a, group.als, group.aes, group.b,
                group.bls, group.bes, group.out, group.m);
}

// Every group of the grid in turn, its lanes as coroutines.
template <int G>
void run_grid(void (*lane)(int), const int32_t* a, int64_t als, int64_t aes, const int32_t* b,
              int64_t bls, int64_t bes, int32_t* out, int64_t m, int64_t threads) {
  group.a = a; group.als = als; group.aes = aes;
  group.b = b; group.bls = bls; group.bes = bes;
  group.out = out; group.m = m; group.size = G;
  for (group.first = 0; group.first < threads; group.first += G) {
    for (int r = 0; r < G; ++r) {
      getcontext(&group.lanes[r]);
      group.lanes[r].uc_stack.ss_sp = group.stacks.data() + r * kStack;
      group.lanes[r].uc_stack.ss_size = kStack;
      // a lane that ends hands over to the next; the last back to the caller
      group.lanes[r].uc_link = r + 1 < G ? &group.lanes[r + 1] : &group.caller;
      makecontext(&group.lanes[r], reinterpret_cast<void (*)()>(lane), 1, r);
    }
    swapcontext(&group.caller, &group.lanes[0]);
  }
}

}  // namespace

#define PLANES const int32_t *a, int64_t als, int64_t aes, const int32_t *b, int64_t bls, \
               int64_t bes, int32_t *out, int64_t m, int threads, int64_t blocks
#define PASS a, als, aes, b, bls, bes, out, m, threads * blocks

extern "C" int host_mul(int g, PLANES) {
  switch (g) {
    case 1:
      for (int64_t gid = 0; gid < threads * blocks; ++gid)
        mul_thread<1>(OneLane{}, gid, a, als, aes, b, bls, bes, out, m);
      return 0;
    case 2: run_grid<2>(mul_lane<2>, PASS); return 0;
    case 4: run_grid<4>(mul_lane<4>, PASS); return 0;
  }
  return -1;
}

extern "C" int host_add(int g, PLANES) {
  switch (g) {
    case 1:
      for (int64_t gid = 0; gid < threads * blocks; ++gid)
        add_thread<1>(OneLane{}, gid, a, als, aes, b, bls, bes, out, m);
      return 0;
    case 2: run_grid<2>(add_lane<2>, PASS); return 0;
    case 4: run_grid<4>(add_lane<4>, PASS); return 0;
    case 8: run_grid<8>(add_lane<8>, PASS); return 0;
  }
  return -1;
}

extern "C" int host_sub(int g, PLANES) {
  switch (g) {
    case 1:
      for (int64_t gid = 0; gid < threads * blocks; ++gid)
        sub_thread<1>(OneLane{}, gid, a, als, aes, b, bls, bes, out, m);
      return 0;
    case 2: run_grid<2>(sub_lane<2>, PASS); return 0;
    case 4: run_grid<4>(sub_lane<4>, PASS); return 0;
    case 8: run_grid<8>(sub_lane<8>, PASS); return 0;
  }
  return -1;
}

// counts[i * m + e] += 1 for every limb store of a grid of `threads`
// threads with g per element: thread gid stores limbs [r L, r L + L), L =
// 32 / g, of element gid / g, r = gid % g, if that element is below m (the
// split of mul_thread, add_thread and sub_thread).
extern "C" int host_cover(int g, int64_t m, int threads, int64_t blocks, int32_t* counts) {
  if (g < 1 || kLimbs % g) return -1;
  const int span = kLimbs / g;
  for (int64_t gid = 0; gid < threads * blocks; ++gid) {
    const int64_t e = gid / g;
    if (e >= m) continue;
    for (int i = 0; i < span; ++i) ++counts[(gid % g * span + i) * m + e];
  }
  return 0;
}

extern "C" int host_constant(const char* name) {
  const std::string n(name);
  if (n == "kMulGroup") return kMulGroup;
  if (n == "kAddGroup") return kAddGroup;
  if (n == "kSubGroup") return kSubGroup;
  if (n == "kMaxThreads") return kMaxThreads;
  return -1;
}
"""

_PLANE_ARGS = [
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
]


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host harness of csrc/fq.cu")
    work = tmp_path_factory.mktemp("fq_host")
    src, lib = work / "harness.cpp", work / "harness.so"
    src.write_text(_HARNESS)
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-shared", "-fPIC", f"-I{CSRC}", "-o", str(lib), str(src)],
        check=True, capture_output=True, timeout=600,
    )
    h = ctypes.CDLL(str(lib))
    for fn in (h.host_mul, h.host_add, h.host_sub):
        fn.argtypes = [ctypes.c_int, *_PLANE_ARGS]
        fn.restype = ctypes.c_int
    h.host_cover.argtypes = [ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
                             ctypes.c_void_p]
    h.host_cover.restype = ctypes.c_int
    h.host_constant.argtypes = [ctypes.c_char_p]
    h.host_constant.restype = ctypes.c_int
    return h


HOST = {
    "mul_mod": lambda x, y: x * y % P,
    "add_mod": lambda x, y: (x + y) % P,
    "sub_mod": lambda x, y: (x - y) % P,
}


def _special() -> list[int]:
    """Edge values, and values whose words or limbs are all ones, so that
    carries run through every limb and word."""
    ones = [(1 << k) - 1 for k in (12, 32, 64, 96, 192, 288, 380)]
    return [0, 1, 2, P - 1, P - 2, (P - 1) // 2, (P + 1) // 2, *ones, P - (1 << 32)]


def _operands(n_random: int, seed: int) -> tuple[list[int], list[int]]:
    """Every pair of special values, then random pairs and pairs near p."""
    sp = _special()
    xs = [x for x in sp for _ in sp]
    ys = [y for _ in sp for y in sp]
    rng = random.Random(seed)
    for _ in range(n_random):
        xs.append(rng.randrange(P))
        ys.append(rng.choice([rng.randrange(P), P - 1 - rng.randrange(1 << 64)]))
    return xs, ys


def _ptr(arr: np.ndarray) -> int:
    return arr.ctypes.data


def _drive(harness, name: str, g: int, a: np.ndarray, b: np.ndarray, m: int,
           geometry: tuple[int, int, int]) -> np.ndarray:
    """Run kernel ``name``'s body over the grid ``geometry`` on planes ``a``,
    ``b`` (an operand with one column is read at lane stride 0); returns the
    (32, m) output, checking that every output limb was written and that the
    words after it were not."""
    group, threads, blocks = geometry
    assert group == g
    out = np.full(32 * m + GUARD, -1, dtype=np.int32)
    args = []
    for x in (a, b):
        x = np.ascontiguousarray(x, dtype=np.int32)
        args += [x, m, 1] if x.shape[1] == m else [x, 1, 0]
    flat = [_ptr(args[0]), args[1], args[2], _ptr(args[3]), args[4], args[5], _ptr(out), m,
            threads, blocks]
    assert getattr(harness, f"host_{name[:3]}")(g, *flat) == 0
    assert (out[32 * m:] == -1).all(), "a thread wrote past the output"
    body = out[: 32 * m].reshape(32, m)
    assert (body >= 0).all(), "an output limb was not written"
    return body


def _with_group(name: str, g: int, m: int) -> tuple[int, int, int]:
    """The wrapper's geometry for kernel ``name`` at ``m`` lanes, with ``g``
    threads per element in place of the wrapper's group size."""
    threads = BP.BLOCK_THREADS[name]
    return g, threads, -(-m * g // threads)


@pytest.mark.parametrize("g", [1, 2, 4])
def test_host_mul_matches_python_ints(harness, g):
    """Each group size the multiply's bodies can take (the one-thread body
    is the group of one)."""
    xs, ys = _operands(120, 100 + g)
    m = len(xs)
    assert m % 32  # a ragged last block and warp
    got = _drive(harness, "mul_mod", g, BP.to_planes(xs), BP.to_planes(ys), m,
                 _with_group("mul_mod", g, m))
    assert BP.from_planes(got) == [x * y % P for x, y in zip(xs, ys)]


@pytest.mark.parametrize(
    "name,g",
    [("add_mod", 1), ("add_mod", 2), ("add_mod", 4), ("add_mod", 8), ("sub_mod", 1),
     ("sub_mod", 2), ("sub_mod", 4), ("sub_mod", 8)],
    ids=["add-g1", "add-g2", "add-g4", "add-g8", "sub", "sub-g2", "sub-g4", "sub-g8"],
)
def test_host_add_sub_match_python_ints(harness, name, g):
    """The shared add/sub body at each group size: the add launches it with
    2 threads per element, the sub with 1, 2 or 4; 8 runs the ballot
    lookahead over eight ranks."""
    xs, ys = _operands(300, 200 + g)
    m = len(xs)
    got = _drive(harness, name, g, BP.to_planes(xs), BP.to_planes(ys), m, _with_group(name, g, m))
    assert BP.from_planes(got) == [HOST[name](x, y) for x, y in zip(xs, ys)]


def _rank_edges() -> tuple[list[int], list[int]]:
    """Sub operands whose borrows and carries cross the boundaries between
    the ranks' limb blocks (limbs 8, 16 and 24): a == b; a = 0, b = p - 1;
    a and b equal in their low limbs, so the borrow out of the difference
    above ripples from there; differences whose low limbs are all zero;
    and borrows that run through zero limbs (2^(12 j) - 1)."""
    rng = random.Random(400)
    xs, ys = [], []

    def pair(x: int, y: int) -> None:
        assert 0 <= x < P and 0 <= y < P
        xs.append(x)
        ys.append(y)

    for v in (0, 1, P - 1, rng.randrange(P), (1 << 192) - 1, 1 << 192):
        pair(v, v)
    pair(0, P - 1)
    pair(P - 1, 0)
    for j in (8, 16, 24, 31):
        low = rng.randrange(1 << (12 * j))
        top = P >> (12 * j)
        for hx, hy in ((0, 1), (1, 0), (top - 2, top - 1), (top - 1, top - 2)):
            pair((hx << (12 * j)) | low, (hy << (12 * j)) | low)  # equal low limbs
        base = rng.randrange(P >> 1)
        step = 1 << (12 * j)
        pair(base + step, base)  # a - b = 2^(12 j): low limbs all zero
        pair(base, base + step)  # a - b = -2^(12 j): borrow out, + p
        pair(step, 1)  # 2^(12 j) - 1: the borrow runs through j - 1 zero limbs
        pair(1, step)
        pair(step, step - 1)
    return xs, ys


@pytest.mark.parametrize("g", [1, 2, 4, 8])
def test_host_sub_across_rank_boundaries(harness, g):
    xs, ys = _rank_edges()
    m = len(xs)
    got = _drive(harness, "sub_mod", g, BP.to_planes(xs), BP.to_planes(ys), m,
                 _with_group("sub_mod", g, m))
    assert BP.from_planes(got) == [(x - y) % P for x, y in zip(xs, ys)]


@pytest.mark.parametrize(
    "name,g",
    [("mul_mod", 1), ("mul_mod", BP.MUL_GROUP), ("add_mod", BP.ADD_GROUP),
     ("sub_mod", BP.SUB_GROUP)],
    ids=["mul-one-thread", "mul-group", "add", "sub"],
)
def test_host_broadcast_operand(harness, name, g):
    """A (32, 1) operand is read at lane stride 0, on either side."""
    xs = _operands(40, 300 + g)[0]
    m = len(xs)
    geometry = _with_group(name, g, m)
    a = BP.to_planes(xs)
    for c in (0, 1, P - 1, random.Random(301).randrange(P)):
        const = BP.to_planes([c])
        got = _drive(harness, name, g, a, const, m, geometry)
        assert BP.from_planes(got) == [HOST[name](x, c) for x in xs]
        got = _drive(harness, name, g, const, a, m, geometry)
        assert BP.from_planes(got) == [HOST[name](c, x) for x in xs]


def _lane_counts() -> list[int]:
    t = BP.MUL_GROUP_THRESHOLD
    return [1, 7, 31, 32, 33, 4072, 20360, t - 1, t, t + 1]


@pytest.mark.parametrize("index", range(10))
def test_mul_geometry_covers_every_limb_once(harness, index):
    """Both sides of the threshold: the regime, a grid of whole warps with
    no spare block, and every output limb stored by exactly one thread (the
    ragged last block's extra threads store nothing)."""
    m = _lane_counts()[index]
    group, threads, blocks = BP._geometry("mul_mod", m)
    below = m < BP.MUL_GROUP_THRESHOLD
    assert group == (BP.MUL_GROUP if below else 1)
    assert threads == BP.BLOCK_THREADS["mul_mod"]
    assert threads % 32 == 0 and threads % group == 0
    assert (blocks - 1) * threads < m * group <= blocks * threads
    counts = np.zeros(32 * m, dtype=np.int32)
    assert harness.host_cover(group, m, threads, blocks, _ptr(counts)) == 0
    assert (counts == 1).all()


@pytest.mark.parametrize("name", ["add_mod", "sub_mod"])
def test_add_sub_geometry_covers_every_limb_once(harness, name):
    want = BP.ADD_GROUP if name == "add_mod" else BP.SUB_GROUP
    for m in (1, 63, 64, 65, 6144, 24576, (1 << 20) + 3):
        group, threads, blocks = BP._geometry(name, m)
        assert (group, threads) == (want, BP.BLOCK_THREADS[name])
        assert threads % 32 == 0 and 32 % group == 0
        assert (blocks - 1) * threads < m * group <= blocks * threads
        counts = np.zeros(32 * m, dtype=np.int32)
        assert harness.host_cover(group, m, threads, blocks, _ptr(counts)) == 0
        assert (counts == 1).all()


def test_host_constants_match_the_wrapper(harness):
    assert harness.host_constant(b"kMulGroup") == BP.MUL_GROUP
    assert harness.host_constant(b"kAddGroup") == BP.ADD_GROUP
    assert harness.host_constant(b"kSubGroup") == BP.SUB_GROUP
    assert max(BP.BLOCK_THREADS.values()) <= harness.host_constant(b"kMaxThreads")
