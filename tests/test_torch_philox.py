"""The counter-keyed Philox draws (`repro_torch.kernels.philox`,
`sim.draws.Philox.uniform_rows`).

What is held, and how tightly (all bit for bit):
* the plain generator reproduces the three Philox4x32-10 known-answer
  vectors of Salmon et al. (SC'11), and an independent numpy uint64
  Philox on random counters and keys;
* a row's values depend on its coordinates only: not on the other rows
  drawn, their number or order, or how many columns of its group are
  drawn; every value lies in [1e-7, 1);
* tags, draw names, strategies, replications and seeds separate streams;
* `Philox.uniform` (the flat paths) gives the values recorded before the
  counter-keyed method existed;
* on a card (`cuda`, skips here): the kernel equals the plain version run
  on the CPU, and its raw generator the known answers.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import philox as ph
from repro_torch.sim.draws import (DRAW_NAMES, FLEET_TAG, NO_BLOCK,
                                   SERVE_TAG, Philox)

KAT = (
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
)

# Philox(7).uniform(...) on the CPU, recorded on the tree before
# uniform_rows existed: the first f32 bit patterns of each draw
FLAT_BITS = (
    (("clone", 0, "key", (3, 4)),
     [1042759370, 1049230310, 1057171801, 1050872272, 1061737563,
      1034767788]),
    (("sresume", 1, "k1", (5,)),
     [1061126795, 1059284529, 1064183520, 1040332718, 1062626134]),
    (("adaptive", 2, "k2", (2, 9)),
     [1061550530, 1057878940, 1065276040, 1050637466, 1059710894,
      1062615842]),
)


def numpy_philox(ctr, key):
    """Philox4x32-10 in numpy uint64, the 64-bit product taken whole:
    ctr (n, 4), key (n, 2) uint32 -> (n, 4) uint32."""
    c = [ctr[:, i].astype(np.uint64) for i in range(4)]
    k0, k1 = (key[:, i].astype(np.uint64) for i in range(2))
    mask = np.uint64(0xFFFFFFFF)
    for i in range(10):
        if i:
            k0 = (k0 + np.uint64(ph.W0)) & mask
            k1 = (k1 + np.uint64(ph.W1)) & mask
        p0 = np.uint64(ph.M0) * c[0]
        p1 = np.uint64(ph.M1) * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k0, p1 & mask,
             (p0 >> np.uint64(32)) ^ c[3] ^ k1, p0 & mask]
    return np.stack(c, axis=1).astype(np.uint32)


def plain_words(ctr, key):
    t = lambda a: torch.from_numpy(a.astype(np.int64))
    out = ph.philox4x32(*(t(ctr[:, i]) for i in range(4)),
                        t(key[:, 0]), t(key[:, 1]))
    return np.stack([o.numpy() for o in out], axis=1).astype(np.uint32)


@pytest.mark.parametrize("ctr,key,want", KAT, ids=["zeros", "ones", "pi"])
def test_known_answer_vectors(ctr, key, want):
    got = plain_words(np.asarray([ctr], np.uint32), np.asarray([key],
                                                               np.uint32))
    assert tuple(int(x) for x in got[0]) == want


def test_plain_generator_equals_numpy_uint64():
    rng = np.random.default_rng(0)
    ctr = rng.integers(0, 2**32, size=(4096, 4), dtype=np.uint64).astype(
        np.uint32)
    key = rng.integers(0, 2**32, size=(4096, 2), dtype=np.uint64).astype(
        np.uint32)
    np.testing.assert_array_equal(plain_words(ctr, key),
                                  numpy_philox(ctr, key))


def test_rows_map_words_to_uniforms():
    """philox_rows_plain's value at (cell, row, column) is word
    column % 4 of the block at counter (cell lo, cell hi, row,
    column // 4), mapped as (x >> 8) * 2^-24 and then to [1e-7, 1)."""
    cells = np.asarray([0, 5, 2**32 + 7, -1, 2**40 + 3], np.int64)
    rows = np.asarray([0, 3, 2**24 - 1, 9, 77], np.int64)
    key = (0x12345678, 0x9ABCDEF0)
    got = ph.philox_rows_plain(torch.from_numpy(cells),
                               torch.from_numpy(rows), 10, key).numpy()
    u = cells.astype(np.uint64)
    for g in range(3):
        ctr = np.stack([u & np.uint64(0xFFFFFFFF), u >> np.uint64(32),
                        rows.astype(np.uint64),
                        np.full(5, g, np.uint64)], 1).astype(np.uint32)
        words = numpy_philox(ctr, np.tile(np.asarray(key, np.uint32),
                                          (5, 1)))
        x = ((words >> 8).astype(np.float32) * np.float32(2.0 ** -24))
        x = np.maximum(x * np.float32(ph.SPAN) + np.float32(ph.MINVAL),
                       np.float32(ph.MINVAL))
        cols = slice(4 * g, min(4 * g + 4, 10))
        np.testing.assert_array_equal(got[:, cols], x[:, :cols.stop
                                                      - cols.start])


@pytest.mark.parametrize("cols", [1, 3, 9, 10])
def test_a_row_depends_on_its_coordinates_only(cols):
    src = Philox(5)
    rng = np.random.default_rng(cols)
    cells = torch.from_numpy(rng.integers(-2, 2**40, 300))
    rows = torch.from_numpy(rng.integers(0, 2**24, 300))
    full = src.uniform_rows("sresume", 1, "k2", cells, rows, (12,), "cpu",
                            tag=SERVE_TAG)
    pick = torch.from_numpy(rng.permutation(300)[:37])
    part = src.uniform_rows("sresume", 1, "k2", cells[pick], rows[pick],
                            (cols,), "cpu", tag=SERVE_TAG)
    assert torch.equal(part, full[pick, :cols])
    one = src.uniform_rows("sresume", 1, "k2", int(cells[3]),
                           rows[3:4], (cols,), "cpu", tag=SERVE_TAG)
    assert torch.equal(one[0], full[3, :cols])


def test_values_lie_in_the_open_unit_range():
    u = Philox(0).uniform_rows("clone", 0, "key", 11,
                               torch.arange(1 << 16), (10,), "cpu")
    assert float(u.min()) >= float(np.float32(1e-7))
    assert float(u.max()) < 1.0
    # the map's extremes: word 0 and word 2^32 - 1
    lo = torch.tensor([0.0]).mul_(ph.SPAN).add_(ph.MINVAL)
    hi = torch.tensor([(2**24 - 1) * 2.0**-24]).mul_(ph.SPAN).add_(
        ph.MINVAL)
    assert float(lo) == float(np.float32(1e-7)) and float(hi) < 1.0


def test_tags_names_and_keys_separate_streams():
    rows = torch.arange(64)
    draw = lambda src=Philox(2), strategy="hedge", rep=0, name="k1", \
        tag=FLEET_TAG: src.uniform_rows(strategy, rep, name, 4, rows, (3,),
                                        "cpu", tag=tag)
    base = draw()
    others = [draw(tag=SERVE_TAG), draw(name="k2"), draw(name="key"),
              draw(strategy="hadoop_s"), draw(rep=1), draw(src=Philox(3))]
    for other in others:
        assert not torch.equal(base, other)
    keys = {Philox(2).rows_key("hedge", 0, n, t) for n in DRAW_NAMES
            for t in (FLEET_TAG, SERVE_TAG)}
    assert len(keys) == 2 * len(DRAW_NAMES)
    # another cell, and the flat stream, differ too
    assert not torch.equal(base, Philox(2).uniform_rows(
        "hedge", 0, "k1", NO_BLOCK, rows, (3,), "cpu"))
    assert not torch.equal(base[:, 0], Philox(2).uniform(
        "hedge", 0, "k1", (64,), "cpu"))


@pytest.mark.parametrize("args,bits", FLAT_BITS,
                         ids=[a[0] for a, _ in FLAT_BITS])
def test_flat_streams_do_not_move(args, bits):
    u = Philox(7).uniform(*args, "cpu").numpy().reshape(-1)
    assert u[:len(bits)].view(np.uint32).tolist() == bits


def test_uniform_cell_is_rows_of_one_cell():
    src = Philox(1)
    a = src.uniform_cell("clone", 2, 9, "key", (40, 9), "cpu")
    b = src.uniform_rows("clone", 2, "key", 9, torch.arange(40), (9,),
                         "cpu", tag=FLEET_TAG)
    assert torch.equal(a, b)
    c = src.uniform_cell("clone", 2, None, "key", (40, 9), "cpu")
    assert torch.equal(c, src.uniform_rows("clone", 2, "key", NO_BLOCK,
                                           torch.arange(40), (9,), "cpu"))


def test_wrapper_routes_by_device():
    before = ph.launches
    cells = torch.arange(8)
    u = ph.philox_rows(cells, cells, 5, (1, 2))
    assert torch.equal(u, ph.philox_rows_plain(cells, cells, 5, (1, 2)))
    assert ph.launches == before
    with pytest.raises(ValueError, match="no kernel"):
        ph.philox_rows(cells.to("meta"), cells.to("meta"), 5, (1, 2))
    with pytest.raises(ValueError, match="must be"):
        Philox(0).uniform_rows("clone", 0, "key", 3, 4, (2,), "cpu")


@pytest.mark.cuda
def test_cuda_kernel_equals_plain():
    """The kernel against the plain version run on the CPU: cells past
    2^32 and negative, rows up to 2^24, 1 to 10 columns, both tags, all
    draw names; and the raw generator's known answers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(0)
    cells = torch.from_numpy(rng.integers(-(2**40), 2**41, 5000))
    rows = torch.from_numpy(rng.integers(0, 2**24 + 1, 5000))
    before = ph.launches
    n = 0
    for cols in (1, 3, 9, 10):
        for tag in (FLEET_TAG, SERVE_TAG):
            for name in DRAW_NAMES:
                src = Philox(11)
                want = src.uniform_rows("adaptive", 3, name, cells, rows,
                                        (cols,), "cpu", tag=tag)
                got = src.uniform_rows("adaptive", 3, name, cells.cuda(),
                                       rows.cuda(), (cols,), "cuda", tag=tag)
                n += 1
                assert torch.equal(got.cpu(), want), (cols, tag, name)
    assert ph.launches == before + n
    ctr = np.asarray([c for c, _, _ in KAT], np.uint32)
    key = np.asarray([k for _, k, _ in KAT], np.uint32)
    got = ph.philox_raw_cuda(ctr, key)
    assert [tuple(int(x) for x in r) for r in got] == [w for _, _, w in KAT]
