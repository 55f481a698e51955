"""Checkpoint loading: a local HF model directory -> the port's params on one
device, or one rank's shard of them over a mesh.

Port of ``fastkv_tpu.core.weights``. The machine with the card has no
``safetensors`` package, so the format is read and written here:

    8 bytes   N, the header's length (unsigned, little-endian)
    N bytes   JSON {name: {"dtype": "BF16", "shape": [...],
                           "data_offsets": [begin, end]}, "__metadata__": {...}}
    the data  each tensor's bytes, row-major, at its offsets counted from the
              byte after the header

A read maps just the bytes of its tensor, or of its range of rows on the
first axis, copy-on-write (nothing is copied until written, and nothing is
written) and populated in bulk (``MAP_POPULATE``), and returns a
``torch.frombuffer`` view of them. Populating in bulk matters: a copy out
of a lazily mapped file takes one page fault at a time, and on the card's
host that, not the copy, sets the rate (PERF.md, section 6).

``load_params`` streams: each stacked leaf is allocated once on the device and
filled layer by layer from the HF ``[out, in]`` tensor, copied to the device
and transposed there. A tensor crosses to the card through one pinned host
buffer (``Staging``) the size of the largest tensor: the copy from pageable
(mapped) memory goes through CUDA's own small staging buffers at a
fraction of the DMA rate. So the host holds at most one tensor besides the
file's mapped pages. Norms are float32, every other weight takes ``dtype``
(default cfg.dtype). The writer sends each tensor from the card through the
same kind of buffer.

``load_params(mesh=)`` reads only this rank's slice of each leaf
(``parallel.sharding.slices`` of the JAX package's specs): its stage's
layers; of an HF ``[out, in]`` tensor, a column-parallel leaf's run of rows
(mapped alone) and a row-parallel leaf's strided run of columns (the rows
are mapped, and only the columns copied out); an untied head's run of
vocabulary rows. The pinned buffer then holds one shard of one tensor, as
the JAX package's loader promises (its ``load_params``: host memory peaks
at one shard of one leaf).
"""

from __future__ import annotations

import dataclasses
import json
import math
import mmap
import os
import struct
from typing import Any, Callable, Dict, Mapping, Optional

import torch

from fastkv_tpu_torch.core.config import ModelConfig
from fastkv_tpu_torch.core.device import resolve_device, torch_dtype
from fastkv_tpu_torch.models import family, llama

# safetensors dtype names <-> torch dtypes
DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}
INDEX_FILE = "model.safetensors.index.json"
SINGLE_FILE = "model.safetensors"


class Staging:
    """One pinned host buffer, grown to the largest tensor asked for, through
    which tensors cross between the host and the card one at a time."""

    def __init__(self):
        self._buf: Optional[torch.Tensor] = None

    def view(self, dtype: torch.dtype, shape) -> torch.Tensor:
        n = math.prod(shape) * dtype.itemsize
        if self._buf is None or self._buf.numel() < n:
            self._buf = None
            self._buf = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        return self._buf[:n].view(dtype).view(shape)

    def to_device(self, src: torch.Tensor, dev: torch.device) -> torch.Tensor:
        """A CPU tensor's copy on ``dev`` (returns once the copy is done, so
        the buffer is free again)."""
        if dev.type != "cuda" or src.is_cuda:
            return src.to(dev)
        st = self.view(src.dtype, src.shape)
        st.copy_(src)
        return st.to(dev)

    def to_host(self, src: torch.Tensor) -> torch.Tensor:
        """A contiguous host copy of ``src``: for a card's tensor a view of
        the buffer, valid until the next call."""
        if not src.is_cuda:
            return src.contiguous()
        st = self.view(src.dtype, src.shape)
        st.copy_(src)
        return st


class SafetensorsFile:
    """One ``.safetensors`` file: its header; ``read`` maps a tensor's bytes."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
        self.path = path
        self.metadata = header.pop("__metadata__", None)
        self.tensors: Dict[str, Dict[str, Any]] = header
        self._data_start = 8 + n

    def keys(self):
        return self.tensors.keys()

    def read(self, name: str, rows: Optional[slice] = None,
             cols: Optional[slice] = None) -> torch.Tensor:
        """Tensor ``name`` (``rows``: a step-1 range of its first axis;
        ``cols``: of its second, a strided view) as a CPU view of the mapped
        file, in the file's dtype."""
        if cols is not None:
            return self.read(name, rows)[:, cols]
        info = self.tensors[name]
        dtype, shape = DTYPES[info["dtype"]], list(info["shape"])
        begin, end = info["data_offsets"]
        if rows is not None:
            start, stop, step = rows.indices(shape[0])
            if step != 1:
                raise ValueError(f"{name}: a row range needs step 1, got {step}")
            stop = max(stop, start)
            row_bytes = math.prod(shape[1:]) * dtype.itemsize
            begin, end = begin + start * row_bytes, begin + stop * row_bytes
            shape[0] = stop - start
        count = (end - begin) // dtype.itemsize
        if count == 0:
            return torch.empty(shape, dtype=dtype)
        start = self._data_start + begin
        base = start - start % mmap.ALLOCATIONGRANULARITY  # a mapping starts on a page
        with open(self.path, "rb") as f:  # the mapping keeps its own descriptor
            mapped = mmap.mmap(f.fileno(), self._data_start + end - base,
                               flags=mmap.MAP_PRIVATE | mmap.MAP_POPULATE,
                               prot=mmap.PROT_READ | mmap.PROT_WRITE, offset=base)
        # the view holds the mapping; it is unmapped with the last view
        return torch.frombuffer(mapped, dtype=dtype, count=count, offset=start - base).view(shape)


def save_safetensors(tensors: Mapping[str, torch.Tensor], path: str,
                     metadata: Optional[Dict[str, str]] = None,
                     dtype: Optional[torch.dtype] = None) -> int:
    """Write ``tensors`` (on any device, any layout) as one safetensors file;
    ``dtype`` casts each on the way. The header comes from shapes alone, then
    each tensor is cast on its device, copied to the host (through one pinned
    buffer, ``Staging``) and written on its own, so the host never holds more
    than one. Returns the bytes of tensor data written."""
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    offset = 0
    for name, t in tensors.items():
        dt = dtype or t.dtype
        nbytes = t.numel() * dt.itemsize
        header[name] = {"dtype": _NAMES[dt], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)  # the data starts 8-byte aligned
    stage = Staging()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name, t in tensors.items():
            host = stage.to_host(t.to(dtype or t.dtype))
            if host.numel():
                f.write(host.reshape(-1).view(torch.uint8).numpy().data)
    return offset


def load_hf_config(model_dir: str) -> Dict[str, Any]:
    with open(os.path.join(model_dir, "config.json")) as f:
        return json.load(f)


def model_config_from_dir(model_dir: str, name: Optional[str] = None,
                          dtype: str = "bfloat16") -> ModelConfig:
    cfg = ModelConfig.from_hf_config(load_hf_config(model_dir),
                                     name=name or os.path.basename(model_dir.rstrip("/")))
    return dataclasses.replace(cfg, dtype=dtype)


class ShardReader:
    """Reads tensors across the shards of a checkpoint directory: the files
    named by ``model.safetensors.index.json``, or the one
    ``model.safetensors``. Each shard is mapped at its first read."""

    def __init__(self, model_dir: str):
        self.model_dir = model_dir
        index_path = os.path.join(model_dir, INDEX_FILE)
        self._files: Dict[str, SafetensorsFile] = {}
        if os.path.exists(index_path):
            with open(index_path) as f:
                self.name_to_file: Dict[str, str] = dict(json.load(f)["weight_map"])
        else:
            single = self._file(SINGLE_FILE)
            self.name_to_file = {n: SINGLE_FILE for n in single.keys()}

    def _file(self, fname: str) -> SafetensorsFile:
        if fname not in self._files:
            self._files[fname] = SafetensorsFile(os.path.join(self.model_dir, fname))
        return self._files[fname]

    def read(self, name: str, rows: Optional[slice] = None,
             cols: Optional[slice] = None) -> torch.Tensor:
        return self._file(self.name_to_file[name]).read(name, rows, cols)

    def names(self):
        return self.name_to_file.keys()

    def shape(self, name: str) -> tuple:
        """Tensor ``name``'s shape, from its shard's header."""
        return tuple(self._file(self.name_to_file[name]).tensors[name]["shape"])


# HF per-layer tensor names (after "model.layers.{l}.") -> the port's stacked leaves
_LAYER_MAP = {
    "self_attn.q_proj.weight": "wq",
    "self_attn.k_proj.weight": "wk",
    "self_attn.v_proj.weight": "wv",
    "self_attn.o_proj.weight": "wo",
    "mlp.gate_proj.weight": "w_gate",
    "mlp.up_proj.weight": "w_up",
    "mlp.down_proj.weight": "w_down",
    "input_layernorm.weight": "ln_attn",
    "post_attention_layernorm.weight": "ln_mlp",
}
_LEAF_TO_HF = {v: k for k, v in _LAYER_MAP.items()}
_TOP_LEVEL = {"embed": "model.embed_tokens.weight", "final_norm": "model.norm.weight",
              "lm_head": "lm_head.weight"}


def hf_tensors(cfg: ModelConfig, params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's params as HF-layout tensors in HF's order (views: each
    linear transposed back to [out, in], nothing copied)."""
    out = {"model.embed_tokens.weight": params["embed"]}
    for l in range(cfg.num_layers):
        for hf_name, leaf in _LAYER_MAP.items():
            w = params["layers"][leaf][l]
            out[f"model.layers.{l}.{hf_name}"] = w if w.dim() == 1 else w.T
    out["model.norm.weight"] = params["final_norm"]
    if not cfg.tie_word_embeddings:
        out["lm_head.weight"] = params["lm_head"].T
    return out


def params_from_hf(cfg: ModelConfig, get: Callable[..., torch.Tensor], device="cuda",
                   dtype=None, mesh=None,
                   shape_of: Optional[Callable[[str], tuple]] = None) -> Dict[str, Any]:
    """The port's params from HF-named tensors (``get(name, rows, cols)``,
    any device and dtype; rows and cols None or a step-1 slice): each
    stacked leaf is allocated once on ``device`` and filled layer by layer,
    each HF ``[out, in]`` tensor copied to the device and transposed there.
    Norms are float32, the rest ``dtype`` (default cfg.dtype). With ``mesh``
    each leaf is this rank's slice (``parallel.sharding``), and only that
    slice is asked of ``get``; ``shape_of(name)``, where given, holds each
    whole tensor's shape to the config's, which a slice alone cannot show."""
    if not family.of(cfg).READS_CHECKPOINTS:
        raise NotImplementedError(f"{cfg.kind}: reading a checkpoint is not ported")
    from fastkv_tpu_torch.parallel import sharding

    dev = resolve_device(device)
    dtype = torch_dtype(dtype or cfg.dtype)
    stage = Staging()
    specs = sharding.full_param_pspecs(cfg)
    if mesh is not None:
        mesh.pcfg.check_model(cfg)

    def put(dst: torch.Tensor, name: str, transpose: bool, shape, sl) -> None:
        # sl: the slice of each dim of the port's leaf of ``shape`` ([in, out]
        # when transposed); HF holds it as [out, in]
        hf_sl, hf_shape = (sl[::-1], shape[::-1]) if transpose else (sl, shape)
        if shape_of is not None and tuple(shape_of(name)) != tuple(hf_shape):
            raise ValueError(f"{name}: shape {tuple(shape_of(name))}, the config needs "
                             f"{tuple(hf_shape)}")
        whole = [s.stop - s.start == n for s, n in zip(hf_sl, hf_shape)]
        rows = None if whole[0] else hf_sl[0]
        cols = None if len(hf_sl) < 2 or whole[1] else hf_sl[1]
        src = get(name, rows, cols)
        want = tuple(dst.shape[::-1]) if transpose else tuple(dst.shape)
        if tuple(src.shape) != want:
            raise ValueError(f"{name}: shape {tuple(src.shape)}, the config needs {want}")
        src = stage.to_device(src, dev)
        dst.copy_(src.T if transpose else src)

    flat = {}
    for key, shp in llama.param_shapes(cfg).items():
        spec = (specs["layers"][key[len("layers."):]] if key.startswith("layers.")
                else specs[key])
        sl = (tuple(slice(0, n) for n in shp) if mesh is None
              else sharding.slices(shp, spec, mesh.pcfg, mesh.place))
        local = tuple(s.stop - s.start for s in sl)
        leaf = torch.empty(local, dtype=torch.float32 if llama.is_norm(key) else dtype,
                           device=dev)
        if key.startswith("layers."):
            hf_name = _LEAF_TO_HF[key[len("layers."):]]
            for i, l in enumerate(range(sl[0].start, sl[0].stop)):
                put(leaf[i], f"model.layers.{l}.{hf_name}", leaf.dim() == 3, shp[1:], sl[1:])
        else:
            put(leaf, _TOP_LEVEL[key], key == "lm_head", shp, sl)
        flat[key] = leaf
    return llama.unflatten(flat)


def params_from_hf_state_dict(cfg: ModelConfig, sd, device="cuda",
                              dtype=None) -> Dict[str, Any]:
    """The port's params from an HF Llama/Mistral state dict (name -> tensor
    or numpy array), as ``fastkv_tpu.models.llama.params_from_hf_state_dict``
    gives the JAX package's."""
    def get(name, rows=None, cols=None):
        t = torch.as_tensor(sd[name])
        t = t if rows is None else t[rows]
        return t if cols is None else t[:, cols]

    return params_from_hf(cfg, get, device=device, dtype=dtype)


def load_params(model_dir: str, cfg: ModelConfig, device="cuda", dtype=None,
                mesh=None) -> Dict[str, Any]:
    """Stream a checkpoint directory into the port's params on ``device``
    (the layout of ``models.llama.param_shapes``); with ``mesh``
    (``parallel.sharding.Mesh``) this rank's shard of them, on the mesh's
    device, read slice by slice."""
    if mesh is not None:
        device = mesh.device
    reader = ShardReader(model_dir)
    if not cfg.tie_word_embeddings and "lm_head.weight" not in reader.name_to_file:
        raise ValueError("config says untied embeddings but no lm_head found")
    return params_from_hf(cfg, reader.read, device=device, dtype=dtype, mesh=mesh,
                          shape_of=reader.shape)
