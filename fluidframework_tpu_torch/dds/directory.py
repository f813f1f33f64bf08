"""SharedDirectory DDS — hierarchical key-value store.

Reference parity: packages/dds/map/src/directory.ts (``SharedDirectory``,
1632 LoC): a tree of subdirectories, each a MapKernel-style LWW key store
with pending-local shadowing; ops carry the absolute subdirectory path.
Reuses :class:`fluidframework_tpu_torch.dds.map_data.MapData` per subdirectory.
"""

from __future__ import annotations

from typing import Any

from ..protocol.messages import SequencedDocumentMessage
from ..runtime.handles import decode_value, encode_value
from .map_data import MapData
from .shared_object import ChannelFactory, SharedObject


def _norm(path: str) -> str:
    parts = [p for p in path.split("/") if p]
    return "/" + "/".join(parts)


class SubDirectory:
    """Client handle to one directory node."""

    def __init__(self, owner: "SharedDirectory", path: str) -> None:
        self._owner = owner
        self.path = _norm(path)

    # -- keys -----------------------------------------------------------------

    def set(self, key: str, value: Any) -> "SubDirectory":
        self._owner._submit_key_op(self.path, "set", key, encode_value(value))
        return self

    def get(self, key: str, default: Any = None) -> Any:
        data = self._owner._dirs.get(self.path)
        if data is None or not data.has(key):
            return default  # caller's default returned untouched
        return decode_value(data.get(key), self._owner._handle_resolver())

    def has(self, key: str) -> bool:
        data = self._owner._dirs.get(self.path)
        return bool(data and data.has(key))

    def delete(self, key: str) -> None:
        self._owner._submit_key_op(self.path, "delete", key, None)

    def clear(self) -> None:
        self._owner._submit_key_op(self.path, "clear", None, None)

    def keys(self):
        data = self._owner._dirs.get(self.path)
        return iter(data.keys()) if data else iter(())

    def items(self):
        data = self._owner._dirs.get(self.path)
        if data is None:
            return iter(())
        resolver = self._owner._handle_resolver()
        return ((k, decode_value(v, resolver)) for k, v in data.items())

    # -- subdirectories --------------------------------------------------------

    def create_sub_directory(self, name: str) -> "SubDirectory":
        child = _norm(f"{self.path}/{name}")
        self._owner._ensure_dir(child)
        self._owner.submit_local_message(
            {"type": "createSubDirectory", "path": self.path, "name": name},
            None)
        return SubDirectory(self._owner, child)

    def get_sub_directory(self, name: str) -> "SubDirectory | None":
        child = _norm(f"{self.path}/{name}")
        return (SubDirectory(self._owner, child)
                if child in self._owner._dirs else None)

    def subdirectories(self) -> list[str]:
        prefix = self.path.rstrip("/") + "/"
        names = set()
        for path in self._owner._dirs:
            if path.startswith(prefix) and path != self.path:
                names.add(path[len(prefix):].split("/")[0])
        return sorted(names)


class SharedDirectory(SharedObject):
    channel_type = "https://graph.microsoft.com/types/directory"

    def __init__(self, channel_id: str, runtime=None, attributes=None) -> None:
        super().__init__(channel_id, runtime, attributes)
        self._dirs: dict[str, MapData] = {"/": MapData()}

    # -- root convenience (directory.ts root-level key API) -------------------

    @property
    def root(self) -> SubDirectory:
        return SubDirectory(self, "/")

    def set(self, key: str, value: Any) -> "SharedDirectory":
        self.root.set(key, value)
        return self

    def get(self, key: str, default: Any = None) -> Any:
        return self.root.get(key, default)

    def has(self, key: str) -> bool:
        return self.root.has(key)

    def delete(self, key: str) -> None:
        self.root.delete(key)

    def items(self):
        return self.root.items()

    def keys(self):
        return self.root.keys()

    def create_sub_directory(self, name: str) -> SubDirectory:
        return self.root.create_sub_directory(name)

    def get_sub_directory(self, name: str) -> SubDirectory | None:
        return self.root.get_sub_directory(name)

    # -- op plumbing -----------------------------------------------------------

    def _ensure_dir(self, path: str) -> MapData:
        path = _norm(path)
        if path not in self._dirs:
            self._dirs[path] = MapData()
            # Parents exist implicitly.
            parent = path.rsplit("/", 1)[0] or "/"
            self._ensure_dir(parent)
        return self._dirs[path]

    def _submit_key_op(self, path: str, kind: str, key: str | None,
                       value: Any) -> None:
        data = self._ensure_dir(path)
        if kind == "set":
            op, metadata = data.local_set(key, value)
        elif kind == "delete":
            op, metadata = data.local_delete(key)
        else:
            op, metadata = data.local_clear()
        self.submit_local_message({**op, "path": path}, (path, metadata))

    def process_core(self, message: SequencedDocumentMessage, local: bool,
                     local_op_metadata: Any) -> None:
        op = message.contents
        if op["type"] == "createSubDirectory":
            child = _norm(f"{op['path']}/{op['name']}")
            self._ensure_dir(child)  # idempotent; concurrent creates merge
            return
        path = _norm(op["path"])
        data = self._ensure_dir(path)
        metadata = local_op_metadata[1] if local else None
        data.process({k: v for k, v in op.items() if k != "path"},
                     local, metadata)

    def resubmit_core(self, contents: Any, metadata: Any) -> None:
        if contents["type"] == "createSubDirectory":
            self.submit_local_message(contents, None)
            return
        path, op_metadata = metadata
        data = self._ensure_dir(path)
        op, new_metadata = data.resubmit(
            {k: v for k, v in contents.items() if k != "path"}, op_metadata)
        self.submit_local_message({**op, "path": path}, (path, new_metadata))

    def on_attach(self) -> None:
        for data in self._dirs.values():
            data.normalize_detached()

    def summarize_core(self) -> dict:
        return {"dirs": {path: data.snapshot()
                         for path, data in sorted(self._dirs.items())}}

    def load_core(self, content: dict) -> None:
        self._dirs = {path: MapData.load(snap)
                      for path, snap in content["dirs"].items()}

    def apply_stashed_op(self, contents: Any) -> Any:
        op = contents
        if op["type"] == "createSubDirectory":
            self._ensure_dir(_norm(f"{op['path']}/{op['name']}"))
            return None
        path = _norm(op["path"])
        data = self._ensure_dir(path)
        if op["type"] == "set":
            _, metadata = data.local_set(op["key"], op["value"])
        elif op["type"] == "delete":
            _, metadata = data.local_delete(op["key"])
        else:
            _, metadata = data.local_clear()
        return (path, metadata)


class SharedDirectoryFactory(ChannelFactory):
    channel_type = SharedDirectory.channel_type
    shared_object_cls = SharedDirectory
