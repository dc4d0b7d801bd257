"""A read-only OCDBT key-value store: the database orbax writes a
checkpoint's tree into (``"use_ocdbt": true``), read without tensorstore.

OCDBT (tensorstore's "optionally-cooperative distributed B+tree") keeps a
root ``manifest.ocdbt`` and data files ``d/<id>``; orbax writes each
process's part into ``ocdbt.process_<n>/`` and then points the root's tree
at those files, so a value may sit in either ``d/`` directory.  Every
encoded part (manifest, version-tree node, B+tree node) is

    magic (u32, big-endian)  length (u64, the part's bytes)
    version (varint, 0)      compression (varint: 0 none, 1 zstd)
    body (a zstd frame when compressed)   CRC-32C of all before it (u32)

and the bodies are columns of varints:

    manifest       config, data-file table, the newest versions inline
                   (generation, root height, root (file, offset, length),
                   key / byte counts, commit time) and references to
                   version-tree nodes holding the older ones
    B+tree node    height, data-file table, prefix-compressed keys; a leaf
                   holds values inline or as (file, offset, length), an
                   interior node its children's references and the length
                   of the prefix its subtree's keys share
    data files     the paths of the files the part refers to, each
                   prefix-compressed against the one before

Values are returned as stored: a zarr chunk of a checkpoint is the zstd
frame ``utils/zstd.py`` decodes.  A field the reader does not understand
raises ``OcdbtError`` naming it; nothing is skipped silently.
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict, List, Sequence, Union

from sdbc_tpu_torch.utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
VERSION_TREE_MAGIC = 0x0CDB1234


class OcdbtError(ValueError):
    """A database the reader cannot read, with the field at fault."""


class _Body:
    """A cursor over a decoded body; every read checks the bounds."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def fail(self, field: str, detail: str = "") -> OcdbtError:
        return OcdbtError(f"{self.what}: {field}" + (f": {detail}"
                                                     if detail else ""))

    def varint(self, field: str) -> int:
        out, shift = 0, 0
        for _ in range(10):
            if self.pos >= len(self.data):
                raise self.fail(field, "ends inside a varint")
            b = self.data[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if b < 0x80:
                if out >= 1 << 64:
                    raise self.fail(field, "a varint beyond 64 bits")
                return out
            shift += 7
        raise self.fail(field, "a varint longer than 10 bytes")

    def varints(self, n: int, field: str) -> List[int]:
        return [self.varint(field) for _ in range(n)]

    def raw(self, n: int, field: str) -> bytes:
        if self.pos + n > len(self.data):
            raise self.fail(field, f"needs {n} bytes, "
                            f"{len(self.data) - self.pos} left")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self, field: str) -> int:
        return self.raw(1, field)[0]

    def u8s(self, n: int, field: str) -> bytes:
        return self.raw(n, field)

    def u64s(self, n: int, field: str) -> List[int]:
        return list(struct.unpack(f"<{n}Q", self.raw(8 * n, field)))

    def end(self) -> None:
        if self.pos != len(self.data):
            raise self.fail("end", f"{len(self.data) - self.pos} bytes left "
                            "over")


def decode_part(data: bytes, magic: int, what: str,
                limit: int = 1 << 30) -> _Body:
    """The body of one encoded part, its header and CRC-32C checked."""
    if len(data) < 12 + 2 + 4:
        raise OcdbtError(f"{what}: {len(data)} bytes, too short")
    got, length = struct.unpack(">I", data[:4])[0], struct.unpack(
        "<Q", data[4:12])[0]
    if got != magic:
        raise OcdbtError(f"{what}: magic {got:#010x}, expected {magic:#010x}")
    if length != len(data):
        raise OcdbtError(f"{what}: length field {length}, {len(data)} bytes")
    crc = struct.unpack("<I", data[-4:])[0]
    if zstd.crc32c(data[:-4]) != crc:
        raise OcdbtError(f"{what}: CRC-32C mismatch")
    head = _Body(data[12:-4], what)
    version = head.varint("version")
    if version != 0:
        raise head.fail("version", f"{version} (only 0 is read)")
    compression = head.varint("compression")
    body = head.data[head.pos:]
    if compression == 1:
        try:
            body = zstd.decompress(body, limit=limit)
        except zstd.ZstdError as e:
            raise head.fail("compressed body", str(e)) from e
    elif compression != 0:
        raise head.fail("compression", f"{compression} (0 none, 1 zstd)")
    return _Body(body, what)


@dataclass(frozen=True)
class Ref:
    """Bytes ``[offset, offset + length)`` of the data file at ``path``."""
    path: str
    offset: int
    length: int


def read_ref(ref: Ref) -> bytes:
    """The bytes ``ref`` names."""
    with open(ref.path, "rb") as f:
        data = os.pread(f.fileno(), ref.length, ref.offset)
    if len(data) != ref.length:
        raise OcdbtError(f"{ref.path}: {len(data)} bytes at {ref.offset}, "
                         f"expected {ref.length}")
    return data


@dataclass(frozen=True)
class Version:
    generation: int
    root_height: int
    root: Ref
    num_keys: int
    commit_time: int


@dataclass(frozen=True)
class Config:
    uuid: bytes
    max_inline_value_bytes: int
    max_decoded_node_bytes: int
    version_tree_arity_log2: int
    compression: str


class OcdbtStore:
    """The newest version of the database at ``path``: ``keys()``,
    ``read(key)``, ``read_many(keys)``, and ``ref(key)``: where a value
    lies (a ``Ref``, or its bytes when stored inline)."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        mpath = os.path.join(self.path, "manifest.ocdbt")
        with open(mpath, "rb") as f:
            body = decode_part(f.read(), MANIFEST_MAGIC, mpath)
        self.config = self._config(body)
        files = self._files(body)
        self._inline = self._versions(body, files)
        self._refs = self._version_refs(body, files, with_height=True)
        body.end()
        self._values: Dict[str, Union[bytes, Ref]] = {}
        if self._inline:
            newest = max(self._inline, key=lambda v: v.generation)
            if newest.num_keys:
                self._walk(newest.root, newest.root_height, b"")
            if len(self._values) != newest.num_keys:
                raise OcdbtError(f"{mpath}: {len(self._values)} keys in the "
                                 f"tree, the version says {newest.num_keys}")

    # -- manifest --------------------------------------------------------

    @staticmethod
    def _config(body: _Body) -> Config:
        uuid = body.raw(16, "config.uuid")
        kind = body.varint("config.manifest_kind")
        if kind != 0:
            raise body.fail("config.manifest_kind",
                            f"{kind} (only 0, a single manifest, is read)")
        inline = body.varint("config.max_inline_value_bytes")
        node = body.varint("config.max_decoded_node_bytes")
        arity = body.u8("config.version_tree_arity_log2")
        method = body.varint("config.compression")
        if method == 1:
            body.raw(4, "config.compression.zstd_level")
            compression = "zstd"
        elif method == 0:
            compression = "none"
        else:
            raise body.fail("config.compression", f"{method} (0 none, 1 zstd)")
        return Config(uuid, inline, node, arity, compression)

    def _files(self, body: _Body) -> List[str]:
        """A data-file table: the files' paths under the database root."""
        n = body.varint("data_file_table.num_files")
        prefix = [0] + body.varints(max(n - 1, 0),
                                    "data_file_table.path_prefix_length")
        suffix = body.varints(n, "data_file_table.path_suffix_length")
        base = body.varints(n, "data_file_table.base_path_length")
        out, prev = [], b""
        for i in range(n):
            if prefix[i] > len(prev):
                raise body.fail("data_file_table.path_prefix_length",
                                f"{prefix[i]} > {len(prev)}")
            full = prev[:prefix[i]] + body.raw(suffix[i],
                                               "data_file_table.path")
            if base[i] > len(full):
                raise body.fail("data_file_table.base_path_length",
                                f"{base[i]} > {len(full)}")
            name = full.decode()
            parts = name.split("/")
            if name.startswith("/") or ".." in parts:
                raise body.fail("data_file_table.path",
                                f"{name!r} leaves the database")
            out.append(os.path.join(self.path, name))
            prev = full
        return out

    @staticmethod
    def _ref_columns(body: _Body, n: int, files: List[str],
                     field: str) -> List[Ref]:
        ids = body.varints(n, f"{field}.data_file_id")
        offsets = body.varints(n, f"{field}.offset")
        lengths = body.varints(n, f"{field}.length")
        for i in ids:
            if i >= len(files):
                raise body.fail(f"{field}.data_file_id",
                                f"{i} of {len(files)} files")
        return [Ref(files[i], o, ln) for i, o, ln in zip(ids, offsets,
                                                         lengths)]

    def _versions(self, body: _Body, files: List[str]) -> List[Version]:
        n = body.varint("versions.count")
        gens = body.varints(n, "versions.generation_number")
        heights = body.u8s(n, "versions.root_height")
        roots = self._ref_columns(body, n, files, "versions.root")
        keys = body.varints(n, "versions.num_keys")
        body.varints(n, "versions.num_tree_bytes")
        body.varints(n, "versions.num_indirect_value_bytes")
        times = body.u64s(n, "versions.commit_time")
        return [Version(*v) for v in zip(gens, heights, roots, keys, times)]

    def _version_refs(self, body: _Body, files: List[str],
                      with_height: bool, height: int = 0) -> list:
        """References to version-tree nodes: (generation, Ref, height)."""
        n = body.varint("version_nodes.count")
        gens = body.varints(n, "version_nodes.generation_number")
        refs = self._ref_columns(body, n, files, "version_nodes.location")
        body.varints(n, "version_nodes.num_generations")
        body.u64s(n, "version_nodes.commit_time")
        heights = (list(body.u8s(n, "version_nodes.height")) if with_height
                   else [height - 1] * n)
        return list(zip(gens, refs, heights))

    def versions(self) -> List[int]:
        """The generation numbers of every version the database keeps (the
        manifest's and those in its version-tree nodes), ascending."""
        gens = [v.generation for v in self._inline]
        stack = list(self._refs)
        while stack:
            _, ref, height = stack.pop()
            what = f"{ref.path}@{ref.offset}"
            body = decode_part(read_ref(ref), VERSION_TREE_MAGIC, what,
                               self.config.max_decoded_node_bytes)
            arity = body.u8("version_node.arity_log2")
            if arity != self.config.version_tree_arity_log2:
                raise body.fail("version_node.arity_log2",
                                f"{arity}, the config says "
                                f"{self.config.version_tree_arity_log2}")
            got = body.u8("version_node.height")
            if got != height:
                raise body.fail("version_node.height",
                                f"{got}, the reference says {height}")
            files = self._files(body)
            if height == 0:
                gens += [v.generation for v in self._versions(body, files)]
            else:
                stack += self._version_refs(body, files, False, height)
            body.end()
        return sorted(gens)

    # -- B+tree ----------------------------------------------------------

    def _walk(self, ref: Ref, height: int, prefix: bytes) -> None:
        what = f"{ref.path}@{ref.offset}"
        body = decode_part(read_ref(ref), BTREE_MAGIC, what,
                           self.config.max_decoded_node_bytes)
        got = body.u8("btree_node.height")
        if got != height:
            raise body.fail("btree_node.height",
                            f"{got}, the reference says {height}")
        files = self._files(body)
        n = body.varint("btree_node.num_entries")
        if n == 0:
            raise body.fail("btree_node.num_entries", "0")
        pre = [0] + body.varints(n - 1, "btree_node.key_prefix_length")
        suf = body.varints(n, "btree_node.key_suffix_length")
        common = (body.varints(n, "btree_node.subtree_common_prefix_length")
                  if height else None)
        keys, prev = [], b""
        for i in range(n):
            if pre[i] > len(prev):
                raise body.fail("btree_node.key_prefix_length",
                                f"{pre[i]} > {len(prev)}")
            key = prev[:pre[i]] + body.raw(suf[i], "btree_node.key")
            if i and key <= prev:
                raise body.fail("btree_node.key", "keys out of order")
            keys.append(key)
            prev = key
        if height == 0:
            lengths = body.varints(n, "leaf.value_length")
            kinds = body.u8s(n, "leaf.value_kind")
            bad = set(kinds) - {0, 1}
            if bad:
                raise body.fail("leaf.value_kind",
                                f"{sorted(bad)} (0 inline, 1 indirect)")
            out = [i for i in range(n) if kinds[i] == 1]
            ids = body.varints(len(out), "leaf.data_file_id")
            offsets = body.varints(len(out), "leaf.offset")
            where = {}
            for i, f, o in zip(out, ids, offsets):
                if f >= len(files):
                    raise body.fail("leaf.data_file_id",
                                    f"{f} of {len(files)} files")
                where[i] = Ref(files[f], o, lengths[i])
            for i in range(n):
                value = where.get(i)
                if value is None:
                    value = body.raw(lengths[i], "leaf.inline_value")
                self._values[(prefix + keys[i]).decode()] = value
            body.end()
            return
        children = self._ref_columns(body, n, files, "interior.child")
        for field in ("num_keys", "num_tree_bytes",
                      "num_indirect_value_bytes"):
            body.varints(n, f"interior.{field}")
        body.end()
        for key, cpl, child in zip(keys, common, children):
            if cpl > len(key):
                raise OcdbtError(f"{what}: subtree_common_prefix_length "
                                 f"{cpl} > {len(key)}")
            self._walk(child, height - 1, prefix + key[:cpl])

    # -- values ----------------------------------------------------------

    def keys(self) -> List[str]:
        return sorted(self._values)

    def __contains__(self, key: str) -> bool:
        return key in self._values

    def ref(self, key: str) -> Union[bytes, Ref]:
        """Where ``key``'s value lies: its bytes when stored inline, else
        the ``Ref`` to read."""
        try:
            return self._values[key]
        except KeyError:
            raise KeyError(f"{self.path}: no key {key!r}") from None

    def read(self, key: str) -> bytes:
        value = self.ref(key)
        return value if isinstance(value, bytes) else read_ref(value)

    def read_many(self, keys: Sequence[str]) -> List[bytes]:
        return [self.read(key) for key in keys]
