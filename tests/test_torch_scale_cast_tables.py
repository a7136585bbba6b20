"""The host-side layout of the fusion-buffer scale/cast kernel (B1,
ops/csrc/scale_cast.cu): ``cuda_kernels.launch_tables``, which lays out
the parameter tables of the launches that cover a list of tensors, taken
as plain Python.

The kernel receives each table by value, one tile per CTA; a CTA finds
its entry from a hint beside the table and a short forward scan.  The
emulation below repeats that lookup and checks that the tiles cover
every element of every member exactly once: empty members, sizes around
one tile and n in {1, 4095, 4096, 4097}, offsets that break 16-byte
alignment, and a list longer than one launch holds.  A repeated list is
a cache hit.
"""

import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import cuda_kernels as K


def _walk(table, itemsize):
    """Element ranges [lo, hi) per entry that the kernel's CTAs cover, one
    tile each, finding their entry as scale_cast.cu does: the host's hint
    (the entry of every hint_stride-th tile, 1024 hints), then a forward
    scan."""
    tile = K.TILE_BYTES // itemsize
    ends = table[:, 3].tolist()
    n_tiles = ends[-1]
    stride = -(-n_tiles // 1024)
    hint, e = [], 0
    for j in range(1024):
        while e < len(ends) - 1 and ends[e] <= j * stride:
            e += 1
        hint.append(e)
    covered = [[] for _ in ends]
    for t in range(n_tiles):
        e = hint[t // stride]
        while ends[e] <= t:
            e += 1
        first = ends[e - 1] if e else 0
        lo = (t - first) * tile
        covered[e].append((lo, min(lo + tile, int(table[e, 2]))))
    return covered


def _check_cover(rows, itemsize):
    tables = K.launch_tables(tuple(rows), itemsize)
    entries = [r for r in rows if r[2]]
    assert sum(len(t) for t in tables) == len(entries)
    assert all(1 <= len(t) <= K.MAX_ENTRIES for t in tables)
    got = [row for t in tables for row in t.tolist()]
    assert [tuple(r[:3]) for r in got] == [tuple(r) for r in entries]
    for table in tables:
        assert not table.flags.writeable
        tile = K.TILE_BYTES // itemsize
        ends = np.cumsum(-(-table[:, 2] // tile))
        assert np.array_equal(table[:, 3], ends)
        for (src, dst, n, _), ranges in zip(table.tolist(),
                                           _walk(table, itemsize)):
            ranges.sort()
            assert ranges[0][0] == 0 and ranges[-1][1] == n
            assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    return tables


@pytest.mark.parametrize("itemsize", [2, 4, 8])
def test_tile_sizes_and_one_tile_edges(itemsize):
    tile = K.TILE_BYTES // itemsize
    rows = [(0x1000 * (i + 1), 0x9000 * (i + 1), n)
            for i, n in enumerate((1, tile - 1, tile, tile + 1, 3 * tile))]
    (table,) = _check_cover(rows, itemsize)
    assert table[:, 3].tolist() == [1, 2, 3, 5, 8]


def test_f32_sizes_4095_4096_4097():
    assert K.TILE_BYTES // 4 == 2048
    (table,) = _check_cover([(16, 32, 1), (48, 64, 4095), (80, 96, 4096),
                             (112, 128, 4097)], 4)
    assert table[:, 3].tolist() == [1, 3, 5, 8]


def test_empty_members_take_no_entry():
    assert K.launch_tables((), 4) == ()
    assert K.launch_tables(((16, 32, 0), (48, 64, 0)), 4) == ()
    (table,) = _check_cover([(16, 32, 0), (48, 64, 5), (80, 96, 0),
                             (112, 128, 9000)], 4)
    assert table[:, 0].tolist() == [48, 112]


def test_unaligned_offsets_of_a_real_bucket():
    """Member views of one f32 buffer at element offsets that are not
    multiples of 4 (16 bytes): the table holds their exact addresses."""
    buf = torch.zeros(20000)
    grads = [torch.zeros(n) for n in (3, 4097, 1, 130, 6000)]
    offs = np.cumsum([0] + [g.numel() for g in grads[:-1]]).tolist()
    rows = [(g.data_ptr(), buf.narrow(0, o, g.numel()).data_ptr(),
             g.numel()) for g, o in zip(grads, offs)]
    assert any(r[1] % 16 for r in rows)
    (table,) = _check_cover(rows, 4)
    assert table[:, 1].tolist() == [buf.data_ptr() + 4 * o for o in offs]


def test_a_list_longer_than_one_launch_splits():
    n = 2 * K.MAX_ENTRIES + 88
    rows = [(0x10000 + 64 * i, 0x900000 + 64 * i, (i * 37) % 5000 + 1)
            for i in range(n)]
    tables = _check_cover(rows, 2)
    assert [len(t) for t in tables] == [K.MAX_ENTRIES, K.MAX_ENTRIES, 88]
    # each launch counts its own tiles from 0
    for t in tables:
        assert t[0, 3] == -(-t[0, 2] // (K.TILE_BYTES // 2))


def test_a_repeated_list_hits_the_cache():
    rows = tuple((0x777000 + 16 * i, 0x888000 + 16 * i, 100 + i)
                 for i in range(161))
    first = K.launch_tables(rows, 4)
    hits = K.launch_tables.cache_info().hits
    again = K.launch_tables(tuple(list(rows)), 4)
    assert again is first
    assert K.launch_tables.cache_info().hits == hits + 1
    assert K.launch_tables(rows, 2) is not first


def test_cpu_pack_of_a_long_ragged_list_takes_the_plain_version():
    """On the CPU the wrappers never build or launch the kernel: a list
    longer than one launch packs and unpacks through the plain version."""
    g = torch.Generator().manual_seed(0)
    srcs = [torch.randn((i * 7) % 50, generator=g) for i in range(600)]
    offs = np.cumsum([0] + [s.numel() for s in srcs[:-1]]).tolist()
    buf = torch.empty(sum(s.numel() for s in srcs), dtype=torch.bfloat16)
    K.reset_launches()
    K.pack_scale_cast(srcs, buf, offs, 0.5)
    outs = [torch.empty_like(s) for s in srcs]
    K.unpack_scale_cast(buf, outs, offs, 2.0)
    assert K.launches == {"fused_scale_cast": 0, "pack_scale_cast": 0,
                          "unpack_scale_cast": 0}
    want = torch.cat([(s * 0.5).to(torch.bfloat16) for s in srcs])
    assert torch.equal(buf, want)
    for o, s, off in zip(outs, srcs, offs):
        assert torch.equal(o, (buf[off:off + s.numel()].float() * 2.0))
