"""Native LMDB file-format reader/writer (no liblmdb dependency).

The reference stores all datasets as LMDB B+trees
(strhub/data/dataset.py:85-93, tools/create_lmdb_dataset.py)
with keys ``num-samples``, ``image-%09d``, ``label-%09d``. This module
implements the on-disk format directly:

  * `LmdbReader`: zero-copy mmap reader — meta-page selection by txnid,
    B+tree descent with binary search, overflow-page (BIGDATA) values.
    Read-only and thread/process safe (the mmap is never written).
  * `LmdbWriter`: single-transaction bulk writer that builds the B+tree
    bottom-up from sorted keys and emits a file readable by liblmdb and by
    `LmdbReader`.

Format reference: LMDB 0.9.x data format (MDB_DATA_VERSION = 1), 4096-byte
pages, 16-byte page headers, 8-byte node headers, 64-bit layout.

Compatibility testing: tests/test_lmdb_fuzz.py fuzzes page-boundary node
sizes, overflow spans, 1..511-byte keys and deep trees, and validates every
emitted file against an independently written structural checker derived
from the LMDB 0.9 struct layout. Residual risk: no golden file authored by
real liblmdb exists in this offline environment, so a misunderstanding of
the spec shared by writer, reader AND the independent validator would pass
undetected; parsing a reference-produced benchmark .mdb remains the final
acceptance test when one is available.
"""

from __future__ import annotations

import mmap
import os
import struct
from pathlib import Path

PAGE_SIZE = 4096
PAGE_HDR = 16
NODE_HDR = 8

MAGIC = 0xBEEFC0DE
DATA_VERSION = 1

# page flags
P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
P_LEAF2 = 0x20

# node flags
F_BIGDATA = 0x01

P_INVALID = 0xFFFFFFFFFFFFFFFF

# MDB_db: md_pad(4) md_flags(2) md_depth(2) branch(8) leaf(8) overflow(8) entries(8) root(8)
_DB = struct.Struct('<IHHQQQQQ')
# MDB_meta prefix: magic(4) version(4) address(8) mapsize(8)
_META_HEAD = struct.Struct('<II q Q')
# page header: pgno(8) pad(2) flags(2) lower(2) upper(2)
_PAGE_HDR = struct.Struct('<QHHHH')


class LmdbError(RuntimeError):
    pass


def open_reader(path):
    """Open an LMDB for point lookups: the native C++ reader
    (data/native/lmdb_reader.cpp) when g++ is there, else the pure-Python
    mmap reader, which also opens a file the native reader refuses (and
    names what is wrong with it). Both expose get()/len()/close()/context-
    manager."""
    from parseq_tpu_torch.data.native import NativeLmdbReader, load

    lib = load()
    if lib is not None:
        try:
            return NativeLmdbReader(path, lib)
        except OSError:
            pass
    return LmdbReader(path)


def _data_file(path) -> Path:
    p = Path(path)
    if p.is_dir():
        return p / 'data.mdb'
    return p


class LmdbReader:
    """Read-only access to an LMDB main database."""

    def __init__(self, path):
        self.path = _data_file(path)
        self._f = open(self.path, 'rb')
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        self._load_meta()

    def close(self):
        self._mm.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _load_meta(self):
        best = None
        for pgno in (0, 1):
            off = pgno * PAGE_SIZE
            _, _, flags, _, _ = _PAGE_HDR.unpack_from(self._mm, off)
            if not flags & P_META:
                continue
            m = off + PAGE_HDR
            magic, version, _, mapsize = _META_HEAD.unpack_from(self._mm, m)
            if magic != MAGIC:
                raise LmdbError(f'{self.path}: bad LMDB magic {magic:#x}')
            if version != DATA_VERSION:
                raise LmdbError(f'{self.path}: unsupported LMDB data version {version}')
            dbs_off = m + _META_HEAD.size
            free_db = _DB.unpack_from(self._mm, dbs_off)
            main_db = _DB.unpack_from(self._mm, dbs_off + _DB.size)
            last_pg, txnid = struct.unpack_from('<QQ', self._mm, dbs_off + 2 * _DB.size)
            if best is None or txnid > best[0]:
                best = (txnid, free_db, main_db)
        if best is None:
            raise LmdbError(f'{self.path}: no valid meta page')
        _, free_db, main_db = best
        self.page_size = free_db[0] or PAGE_SIZE
        self._root = main_db[7]
        self._entries = main_db[6]
        self._depth = main_db[2]

    def __len__(self):
        return self._entries

    # -- page access ---------------------------------------------------------

    def _page(self, pgno):
        off = pgno * self.page_size
        p_pgno, pad, flags, lower, upper = _PAGE_HDR.unpack_from(self._mm, off)
        return off, flags, lower, upper

    def _numkeys(self, lower):
        return (lower - PAGE_HDR) >> 1

    def _node(self, page_off, idx):
        ptr = struct.unpack_from('<H', self._mm, page_off + PAGE_HDR + 2 * idx)[0]
        noff = page_off + ptr
        lo, hi, flags, ksize = struct.unpack_from('<HHHH', self._mm, noff)
        return noff, lo, hi, flags, ksize

    def _node_key(self, noff, ksize) -> bytes:
        return bytes(self._mm[noff + NODE_HDR : noff + NODE_HDR + ksize])

    def _branch_pgno(self, lo, hi, flags) -> int:
        return lo | (hi << 16) | (flags << 32)

    def _leaf_data(self, noff, lo, hi, flags, ksize) -> bytes:
        dsize = lo | (hi << 16)
        if flags & F_BIGDATA:
            ovpg = struct.unpack_from('<Q', self._mm, noff + NODE_HDR + ksize)[0]
            ooff = ovpg * self.page_size
            return bytes(self._mm[ooff + PAGE_HDR : ooff + PAGE_HDR + dsize])
        d = noff + NODE_HDR + ksize
        return bytes(self._mm[d : d + dsize])

    # -- lookup ---------------------------------------------------------------

    def get(self, key: bytes):
        if self._root == P_INVALID:
            return None
        pgno = self._root
        while True:
            off, flags, lower, upper = self._page(pgno)
            n = self._numkeys(lower)
            if flags & P_BRANCH:
                # find last child whose key <= target (entry 0 has empty key)
                lo_i, hi_i = 1, n - 1
                child = 0
                while lo_i <= hi_i:
                    mid = (lo_i + hi_i) // 2
                    noff, lo, hi, nflags, ksize = self._node(off, mid)
                    if self._node_key(noff, ksize) <= key:
                        child = mid
                        lo_i = mid + 1
                    else:
                        hi_i = mid - 1
                noff, lo, hi, nflags, _ = self._node(off, child)
                pgno = self._branch_pgno(lo, hi, nflags)
            elif flags & P_LEAF:
                lo_i, hi_i = 0, n - 1
                while lo_i <= hi_i:
                    mid = (lo_i + hi_i) // 2
                    noff, lo, hi, nflags, ksize = self._node(off, mid)
                    k = self._node_key(noff, ksize)
                    if k == key:
                        return self._leaf_data(noff, lo, hi, nflags, ksize)
                    if k < key:
                        lo_i = mid + 1
                    else:
                        hi_i = mid - 1
                return None
            else:
                raise LmdbError(f'unexpected page flags {flags:#x} at pgno {pgno}')

    def items(self):
        """Iterate (key, value) in key order (full tree walk)."""
        if self._root == P_INVALID:
            return
        stack = [(self._root, 0)]
        while stack:
            pgno, idx = stack.pop()
            off, flags, lower, upper = self._page(pgno)
            n = self._numkeys(lower)
            if flags & P_BRANCH:
                for i in range(n - 1, idx - 1, -1):
                    noff, lo, hi, nflags, _ = self._node(off, i)
                    stack.append((self._branch_pgno(lo, hi, nflags), 0))
            elif flags & P_LEAF:
                for i in range(n):
                    noff, lo, hi, nflags, ksize = self._node(off, i)
                    yield self._node_key(noff, ksize), self._leaf_data(noff, lo, hi, nflags, ksize)

    def keys(self):
        for k, _ in self.items():
            yield k


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


def _even(n):
    return (n + 1) & ~1


class LmdbWriter:
    """Bulk writer: collects key/value pairs, builds the B+tree on close().

    Produces a single-transaction database equivalent to one big liblmdb
    write txn. Keys are sorted internally (memcmp order), duplicates raise.
    """

    def __init__(self, path, map_size=None):
        p = Path(path)
        if p.suffix != '.mdb':
            p.mkdir(parents=True, exist_ok=True)
            p = p / 'data.mdb'
        self.path = p
        self._kv = {}

    # liblmdb rejects empty keys and keys over its compile-time default
    # MDB_MAXKEYSIZE=511 (MDB_BAD_VALSIZE); enforce the same bounds so every
    # file we emit is one liblmdb could have produced.
    MAX_KEY_SIZE = 511

    def put(self, key: bytes, value: bytes):
        if isinstance(key, str):
            key = key.encode()
        if isinstance(value, str):
            value = value.encode()
        if not 1 <= len(key) <= self.MAX_KEY_SIZE:
            raise LmdbError(f'bad key size {len(key)} (liblmdb allows 1..{self.MAX_KEY_SIZE})')
        self._kv[bytes(key)] = bytes(value)

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        if et is None:
            self.close()

    def close(self):
        items = sorted(self._kv.items())
        pages = []  # list of bytes, index = pgno - 2 (pages 0,1 are meta)

        def page_bytes(pgno, flags, nodes):
            """Assemble a branch/leaf page from a list of node byte strings."""
            n = len(nodes)
            lower = PAGE_HDR + 2 * n
            body = bytearray(PAGE_SIZE)
            upper = PAGE_SIZE
            ptrs = []
            for node in nodes:
                upper -= _even(len(node))
                body[upper : upper + len(node)] = node
                ptrs.append(upper)
            _PAGE_HDR.pack_into(body, 0, pgno, 0, flags, lower, upper)
            for i, ptr in enumerate(ptrs):
                struct.pack_into('<H', body, PAGE_HDR + 2 * i, ptr)
            return bytes(body)

        n_overflow = 0
        n_leaf = 0
        n_branch = 0

        # ---- build leaves --------------------------------------------------
        leaf_entries = []  # (first_key, pgno)
        cur_nodes = []
        cur_size = PAGE_HDR  # header + ptrs + nodes

        def leaf_node(key, val):
            nonlocal n_overflow
            # inline if node fits comfortably (liblmdb: data > mp_size/16ish
            # goes to overflow; exact threshold not required for validity)
            inline_limit = (PAGE_SIZE - PAGE_HDR) // 2 - NODE_HDR - len(key) - 2
            if len(val) <= max(inline_limit, 0) and NODE_HDR + len(key) + len(val) <= PAGE_SIZE - PAGE_HDR - 2:
                hdr = struct.pack('<HHHH', len(val) & 0xFFFF, len(val) >> 16, 0, len(key))
                return hdr + key + val
            # overflow
            n_pages = (len(val) + PAGE_HDR + PAGE_SIZE - 1) // PAGE_SIZE
            data = bytearray(n_pages * PAGE_SIZE)
            first = len(pages) + 2
            _PAGE_HDR.pack_into(data, 0, first, 0, P_OVERFLOW, 0, 0)
            struct.pack_into('<I', data, 12, n_pages)  # pb_pages overlays lower/upper
            data[PAGE_HDR : PAGE_HDR + len(val)] = val
            for i in range(n_pages):
                pages.append(bytes(data[i * PAGE_SIZE : (i + 1) * PAGE_SIZE]))
            n_overflow += n_pages
            hdr = struct.pack('<HHHH', len(val) & 0xFFFF, len(val) >> 16, F_BIGDATA, len(key))
            return hdr + key + struct.pack('<Q', first)

        def flush_leaf():
            nonlocal cur_nodes, cur_size, n_leaf
            if not cur_nodes:
                return
            first_key = cur_nodes[0][1]
            pgno = len(pages) + 2
            pages.append(page_bytes(pgno, P_LEAF, [n for n, _ in cur_nodes]))
            leaf_entries.append((first_key, pgno))
            n_leaf += 1
            cur_nodes, cur_size = [], PAGE_HDR

        for key, val in items:
            node = leaf_node(key, val)
            need = _even(len(node)) + 2
            if cur_size + need > PAGE_SIZE:
                flush_leaf()
            cur_nodes.append((node, key))
            cur_size += need
        flush_leaf()

        # ---- build branches bottom-up --------------------------------------
        level = leaf_entries
        depth = 1
        while len(level) > 1:
            next_level = []
            cur = []
            cur_sz = PAGE_HDR

            def branch_node(key, child_pgno, first):
                k = b'' if first else key
                hdr = struct.pack('<HHHH', child_pgno & 0xFFFF, (child_pgno >> 16) & 0xFFFF,
                                  (child_pgno >> 32) & 0xFFFF, len(k))
                return hdr + k

            def flush_branch():
                nonlocal cur, cur_sz, n_branch
                if not cur:
                    return
                first_key = cur[0][1]
                pgno = len(pages) + 2
                nodes = [branch_node(k, c, i == 0) for i, (_, k, c) in enumerate(cur)]
                pages.append(page_bytes(pgno, P_BRANCH, nodes))
                next_level.append((first_key, pgno))
                n_branch += 1
                cur, cur_sz = [], PAGE_HDR

            for key, child in level:
                need = _even(NODE_HDR + len(key)) + 2
                if cur_sz + need > PAGE_SIZE:
                    flush_branch()
                cur.append((None, key, child))
                cur_sz += need
            flush_branch()
            level = next_level
            depth += 1

        root = level[0][1] if level else P_INVALID
        if not items:
            depth = 0

        # ---- meta pages -----------------------------------------------------
        last_pg = len(pages) + 1
        mapsize = max((last_pg + 1) * PAGE_SIZE, 1 << 20)

        def meta_page(pgno, txnid):
            body = bytearray(PAGE_SIZE)
            _PAGE_HDR.pack_into(body, 0, pgno, 0, P_META, 0, 0)
            m = PAGE_HDR
            _META_HEAD.pack_into(body, m, MAGIC, DATA_VERSION, 0, mapsize)
            dbs = m + _META_HEAD.size
            # FREE_DBI: md_pad = page size; empty db
            _DB.pack_into(body, dbs, PAGE_SIZE, 0, 0, 0, 0, 0, 0, P_INVALID)
            # MAIN_DBI
            _DB.pack_into(body, dbs + _DB.size, 0, 0, depth, n_branch, n_leaf,
                          n_overflow, len(items), root)
            struct.pack_into('<QQ', body, dbs + 2 * _DB.size, last_pg, txnid)
            return bytes(body)

        with open(self.path, 'wb') as f:
            f.write(meta_page(0, 0))
            f.write(meta_page(1, 1))
            for p in pages:
                f.write(p)
        # liblmdb also expects a lock file to be creatable; not needed to read.
