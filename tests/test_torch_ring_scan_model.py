"""A numpy model of the ring kernel's algorithm (``csrc/ring_project.cu``)
against the plain selection ``ring_select_reference``, on the CPU.

The kernel cannot run here, so its algorithm is modelled step for step and
held bit-exact against the function it must compute:

* each scan is cut into C contiguous slices (one CTA of a cluster each),
  each slice into chunks of ``threads * items`` points, each chunk into
  runs of ``items`` points per thread;
* a point is the segment state ``(m, t, a)``: ``m`` the largest clamped
  pixel, ``t`` the smallest (key, position) among the points whose running
  max equals ``m``, ``a`` the smallest over all points; segments combine
  with the associative operator of the kernel. A thread folds its points in
  order, the block scans the threads' states (a Hillis-Steele scan, so the
  operator meets other bracketings than the sequential one), and a CTA's
  carry-in is the fold of the lower ranks' slice aggregates;
* point ``i`` ends a run iff it is the last point or ``v[i+1] > cpix[i]``;
  its pixel (if below ``n_pix``) then takes the run's winner (key,
  position). Every other pixel is empty: the pixels between two runs' and
  after the last run's;
* the pixels are cut into windows of ``K = min(window, ceil(n_pix / C))``
  (rounded up to 4), window ``r`` of each pass of ``C * K`` pixels owned
  by CTA ``r``. In a pass, every CTA sends the winners of its run ends to
  the windows of their owners (each window starts empty), and then every
  CTA writes its own window whole.

Every pixel below ``n_pix`` must be written exactly once: the model
counts the writes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplio_tpu_torch.ops import projection_ring as tring  # noqa: E402
from tests.test_torch_projection import _ring_cases  # noqa: E402

H, W, FU, FD = 32, 128, 3.0, -25.0
SENTINEL = tring.SENTINEL
LLMAX = np.iinfo(np.int64).max          # (SENTINEL, 2^32 - 1): the empty t
IDENT = (-1, LLMAX, LLMAX)
POISON = 0x5A5A5A5A


def combine(a, b):
    if b[0] > a[0]:
        return (b[0], b[1], min(a[2], b[2]))
    return (a[0], min(a[1], b[2]), min(a[2], b[2]))


def fold(states):
    out = IDENT
    for s in states:
        out = combine(out, s)
    return out


def block_scan(states):
    """Exclusive scan by Hillis-Steele (lower lanes on the left) and the
    block total."""
    inc = list(states)
    o = 1
    while o < len(inc):
        inc = [combine(inc[t - o], inc[t]) if t >= o else inc[t]
               for t in range(len(inc))]
        o *= 2
    return [IDENT] + inc[:-1], inc[-1]


def model_scan(v, kt, n_pix, C, threads, items, window, out, count):
    """One scan: v clamped pixels, kt (key << 32 | position); writes each
    pixel's winner t (LLMAX for empty) into ``out`` and counts the writes."""
    n = len(v)
    slc = ((n - 1) // C // items + 1) * items if n else items
    chunk = threads * items

    def point(i):
        return (int(v[i]), int(kt[i]), int(kt[i])) if i < n else IDENT

    def chunk_states(c0, hi):
        return [fold(point(i) if i < hi else IDENT
                     for i in range(c0 + t * items, c0 + (t + 1) * items))
                for t in range(threads)]

    slices = [(min(n, r * slc), min(n, r * slc + slc)) for r in range(C)]
    aggs = []
    for lo, hi in slices:
        agg = IDENT
        for c0 in range(lo, hi, chunk):
            agg = combine(agg, block_scan(chunk_states(c0, hi))[1])
        aggs.append(agg)
    K = min(window, (-(-n_pix // C) + 3) // 4 * 4)
    for pass0 in range(0, n_pix, C * K):
        win = [[LLMAX] * K for _ in range(C)]
        sent = [[0] * K for _ in range(C)]
        for r, (lo, hi) in enumerate(slices):
            carry = fold(aggs[:r])
            for c0 in range(lo, hi, chunk):
                excl, total = block_scan(chunk_states(c0, hi))
                for t in range(threads):
                    s = combine(carry, excl[t])
                    for i in range(c0 + t * items, c0 + (t + 1) * items):
                        if i >= hi:
                            break
                        s = combine(s, point(i))
                        off = s[0] - pass0
                        if (i + 1 == n or v[i + 1] > s[0]) and \
                                s[0] < n_pix and 0 <= off < C * K:
                            win[off // K][off % K] = s[1]  # a run ends
                            sent[off // K][off % K] += 1
                carry = combine(carry, total)
        assert max(max(x) for x in sent) <= 1, "two winners for a pixel"
        for r in range(C):                     # each CTA writes its window
            own = pass0 + r * K
            for q in range(max(0, min(K, n_pix - own))):
                out[own + q] = win[r][q]
                count[own + q] += 1


def model_select(pix, key, p1, p2, n_pix, C, threads, items, window=8):
    """[B, N] int32 x4 -> okey, op1, op2 [B, n_pix], write counts."""
    pix, key, p1, p2 = (np.asarray(a) for a in (pix, key, p1, p2))
    b, n = pix.shape
    okey = np.full((b, n_pix), POISON, np.int32)
    op1, op2 = okey.copy(), okey.copy()
    counts = np.zeros((b, n_pix), np.int64)
    pos = np.arange(n, dtype=np.int64)
    for s in range(b):
        v = np.maximum(pix[s].astype(np.int64), 0)
        kt = (key[s].astype(np.int64) << 32) | pos
        out = {}
        model_scan(v, kt, n_pix, C, threads, items, window, out, counts[s])
        for p, t in out.items():
            if t == LLMAX:
                okey[s, p], op1[s, p], op2[s, p] = SENTINEL, 0, 0
            else:
                i = t & 0xFFFFFFFF
                okey[s, p], op1[s, p], op2[s, p] = t >> 32, p1[s, i], p2[s, i]
    return okey, op1, op2, counts


def _check(words, n_pix, **layout):
    *got, counts = model_select(*(w.numpy() for w in words), n_pix, **layout)
    ref = tring.ring_select_reference(*words, n_pix)
    assert (counts == 1).all(), "a pixel written other than once"
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r.numpy())


LAYOUTS = {"C1 t4 i4": dict(C=1, threads=4, items=4),
           "C2 t8 i2 w4": dict(C=2, threads=8, items=2, window=4),
           "C8 t4 i4": dict(C=8, threads=4, items=4),
           "C8 t2 i8 w4": dict(C=8, threads=2, items=8, window=4),
           "C8 t16 i1 w64": dict(C=8, threads=16, items=1, window=64),
           "C16 t4 i4 w8192": dict(C=16, threads=4, items=4, window=8192)}


def _ring_words(pts, valid):
    p = torch.from_numpy(pts)
    t = [p[..., c].contiguous() for c in range(4)]
    return tring.ring_prologue(*t, torch.from_numpy(valid), H, W, FU, FD)


@pytest.fixture(scope="module")
def ring_words():
    cases = _ring_cases(512, np.random.default_rng(5))
    pts = np.stack([c[0] for c in cases.values()])
    vld = np.stack([c[1] for c in cases.values()])
    return _ring_words(pts, vld)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_model_on_ring_cases(ring_words, layout):
    """ring, interleaved invalid, pure tail, leading prefix, all invalid,
    order violations: one batch of six scans."""
    _check(ring_words, H * W, **LAYOUTS[layout])


def _words(pix, key=None, seed=0):
    """Hand-made words: unique keys (a random permutation unless given)."""
    rng = np.random.default_rng(seed)
    pix = np.atleast_2d(np.asarray(pix, np.int32))
    b, n = pix.shape
    if key is None:
        key = np.stack([rng.permutation(n) * 7 + 3 for _ in range(b)])
    p1, p2 = (rng.integers(-2**31, 2**31, (b, n)).astype(np.int32)
              for _ in range(2))
    return [torch.from_numpy(np.ascontiguousarray(a, np.int32))
            for a in (pix, key, p1, p2)]


SMALL = {
    "N=1": ([[5]], 16),
    "N=1 invalid": ([[-1]], 16),
    "N=1 tail": ([[16]], 16),
    "N=5": ([[3, -1, 2, 9, 9]], 16),
    "N=3 < C": ([[1, 0, 7], [-1, -1, -1]], 8),
    # the clamp trap: -1 run followed by pixel 0 is one run on pixel 0
    "prefix then pixel 0": ([[-1, -1, -1, 0, 0, 4, -1, 4]], 8),
    "prefix then pixel 0 only": ([[-1, -1, 0]], 4),
    "pixels beyond n_pix": ([[2, 40, 3, 17, 99, -1]], 16),
    "decreasing": ([[9, 8, 7, 6, 5, 4, 3, 2, 1, 0]], 12),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("case", list(SMALL))
def test_model_small_scans(case, layout):
    pix, n_pix = SMALL[case]
    _check(_words(pix), n_pix, **LAYOUTS[layout])


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_model_sparse_and_empty(layout):
    """Sparse scans (n_pix >> N: long empty stretches, several passes), a
    key equal to SENTINEL, and N = 0."""
    rng = np.random.default_rng(9)
    n, n_pix = 37, 5000
    pix = np.sort(rng.integers(-1, n_pix + 3, (3, n)), axis=1)
    pix[1, ::4] = -1
    pix[2] = rng.integers(-1, n_pix, n)                    # no ring order
    words = _words(pix)
    words[1][0, 5] = SENTINEL                              # the largest key
    _check(words, n_pix, **LAYOUTS[layout])
    _check(_words(np.zeros((2, 0), np.int32)), 7, **LAYOUTS[layout])

