"""Scene state as dataclasses of torch tensors.

The reference keeps scene state as Vulkan buffers addressed through `ObjDesc`
(VKT/ray_tracing__before/shaders/host_device.h:59-66), camera matrices in a
`GlobalUniforms` UBO (host_device.h:69-75) and per-frame knobs in
`PushConstantRay` (host_device.h:90-98). Here they are plain dataclasses:

* `Material`   — SoA clone of `WaveFrontMaterial` (host_device.h:117-129)
* `Light` + `RenderSettings` — clone of `PushConstantRay`
* `TriangleMesh` / `Torus` / `Instance` / `SceneDef` — the host scene graph
  (NumPy; the BLAS/TLAS analog, hello_vulkan.cpp:602-687)
* `Scene` — the trace-ready flattened scene (world-space triangles with
  precomputed Woop transforms + torus batch + material/texture tables)

Device tensors are float32 / int32. `Scene.to(device)` gives the scene's
one copy on a device (`derived`).
The texture atlas keeps its packed u32 words as int32 tensors holding the
same 32 bits (torch has no general-purpose uint32 arithmetic); see
`tex_dequant`.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Optional

import numpy as np
import torch

F32 = np.float32
I32 = np.int32

LIGHT_POINT = 0     # VKT/ray_tracing__before/shaders/raytrace.rchit:61-67
LIGHT_INFINITE = 1  # raytrace.rchit:68-71

ILLUM_DIFFUSE_ONLY = 0   # no ambient add (wavefront.glsl:28)
ILLUM_AMBIENT = 1        # ambient added, no specular (wavefront.glsl:36)
ILLUM_PHONG = 2          # ambient + Phong specular
ILLUM_REFLECTIVE = 3     # mirror reflection chain (raytrace.rchit:123)


def _tensor(a) -> torch.Tensor:
    """Host array -> CPU tensor sharing its memory (float32/int32/bool only:
    no float64 may reach the device)."""
    a = np.ascontiguousarray(a)
    if a.dtype not in (np.float32, np.int32, np.bool_):
        raise TypeError(f"scene arrays are float32/int32/bool, got {a.dtype}")
    return torch.from_numpy(a)


def _to(obj, device):
    """Copy of a dataclass with every tensor (recursively) on `device`."""
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            changes[f.name] = v.to(device)
        elif dataclasses.is_dataclass(v):
            changes[f.name] = _to(v, device)
    return dataclasses.replace(obj, **changes)


def _tensors(obj) -> list:
    """Every tensor of a dataclass, recursively, in field order."""
    out = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif dataclasses.is_dataclass(v):
            out.extend(_tensors(v))
    return out


_derived: dict = {}


def derived(obj, key, make):
    """make()'s result, kept per object and key (a scene's copy on a
    device, its padded form for a mesh). It is made again when a tensor of
    `obj` was replaced or changed in place since (its `_version` moved),
    and dropped by a weakref callback when `obj` is collected (a `Scene`
    is unhashable, so it cannot key a WeakKeyDictionary). A result that is
    `obj` itself is not kept (the entry would keep `obj` alive)."""
    k = (id(obj), key)
    tensors = _tensors(obj)
    hit = _derived.get(k)
    if (hit is not None and hit[0]() is obj and len(hit[1]) == len(tensors)
            and all(a is b and a._version == v
                    for a, (b, v) in zip(tensors, hit[1]))):
        return hit[2]
    out = make()
    if out is not obj:
        ref = weakref.ref(obj, lambda _r, k=k: _derived.pop(k, None))
        _derived[k] = (ref, [(t, t._version) for t in tensors], out)
    return out


@dataclasses.dataclass
class Material:
    """SoA material table, one row per material (WaveFrontMaterial,
    host_device.h:117-129)."""

    ambient: torch.Tensor        # (M, 3) f32
    diffuse: torch.Tensor        # (M, 3) f32
    specular: torch.Tensor       # (M, 3) f32
    transmittance: torch.Tensor  # (M, 3) f32
    emission: torch.Tensor       # (M, 3) f32
    shininess: torch.Tensor      # (M,)  f32
    ior: torch.Tensor            # (M,)  f32
    dissolve: torch.Tensor       # (M,)  f32
    illum: torch.Tensor          # (M,)  i32
    texture_id: torch.Tensor     # (M,)  i32  (-1 = none; raytrace.rchit:79)

    @staticmethod
    def table(rows: "list[dict]") -> "Material":
        """Build a material table from a list of dicts of WaveFront fields."""

        def col(key, default, width=None):
            arr = np.asarray([r.get(key, default) for r in rows])
            if width is not None:
                arr = arr.reshape(len(rows), width).astype(F32)
            return arr

        return Material(
            ambient=_tensor(col("ambient", (0.1, 0.1, 0.1), 3)),
            diffuse=_tensor(col("diffuse", (0.7, 0.7, 0.7), 3)),
            specular=_tensor(col("specular", (1.0, 1.0, 1.0), 3)),
            transmittance=_tensor(col("transmittance", (0.0, 0.0, 0.0), 3)),
            emission=_tensor(col("emission", (0.0, 0.0, 0.0), 3)),
            shininess=_tensor(col("shininess", 0.0).astype(F32)),
            ior=_tensor(col("ior", 1.0).astype(F32)),
            dissolve=_tensor(col("dissolve", 1.0).astype(F32)),
            illum=_tensor(col("illum", 2).astype(I32)),
            texture_id=_tensor(col("texture_id", -1).astype(I32)),
        )


@dataclasses.dataclass
class Light:
    """Point or infinite light (raytrace.rchit:57-71)."""

    position: torch.Tensor   # (3,) f32 — position (point) or direction (infinite)
    intensity: float         # f32 value
    type: int                # LIGHT_POINT | LIGHT_INFINITE


@dataclasses.dataclass
class RenderSettings:
    """Per-frame knobs: clone of `PushConstantRay` (host_device.h:90-98) plus
    the AA / mip extensions. Scalars are Python numbers holding float32
    values: the bounce loop and raygen read them on the host."""

    clear_color: torch.Tensor  # (4,) f32
    light: Light
    max_depth: int             # bounce cap (reference default 10, hello_vulkan.h:153)
    rho: float                 # toroidal ring radius (reference sweep 4..10)
    pixel_spread: float = 0.0  # world-units-per-unit-distance pixel footprint
    # for texture mip LOD; 0 = auto-filled from the camera by render()

    @staticmethod
    def default(
        clear_color=(1.0, 1.0, 1.0, 1.0),
        light_position=(10.0, 15.0, 8.0),
        light_intensity=100.0,
        light_type=LIGHT_POINT,
        max_depth=10,
        rho=4.0,
        pixel_spread=0.0,
    ) -> "RenderSettings":
        return RenderSettings(
            clear_color=_tensor(np.asarray(clear_color, dtype=F32)),
            light=Light(
                position=_tensor(np.asarray(light_position, dtype=F32)),
                intensity=float(F32(light_intensity)),
                type=int(light_type),
            ),
            max_depth=int(max_depth),
            rho=float(F32(rho)),
            pixel_spread=float(F32(pixel_spread)),
        )

    def to(self, device) -> "RenderSettings":
        return _to(self, device)


# ---------------------------------------------------------------------------
# Host-side scene description (the "loadModel + instances" level), NumPy
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TriangleMesh:
    """One OBJ model == one BLAS (hello_vulkan.cpp:602-663). NumPy host
    arrays; flattened into the `Scene` by `scene.build.build_scene`."""

    positions: np.ndarray        # (V, 3) f32
    normals: np.ndarray          # (V, 3) f32
    colors: np.ndarray           # (V, 3) f32 (reference Vertex.color)
    uvs: np.ndarray              # (V, 2) f32
    indices: np.ndarray          # (T, 3) i32
    mat_index: np.ndarray        # (T,)  i32 — per-triangle material
    materials: list              # list[dict] WaveFront fields for Material.table
    textures: list = dataclasses.field(default_factory=list)  # list[(H,W,3) f32]

    @property
    def num_triangles(self) -> int:
        return int(self.indices.shape[0])


@dataclasses.dataclass
class Torus:
    """Analytic torus primitive: axis +y in object space, centered at origin.
    Implicit surface (x^2+y^2+z^2 + R^2 - r^2)^2 = 4 R^2 (x^2+z^2)."""

    major_radius: float
    minor_radius: float
    materials: list              # list[dict] (single-entry typical)
    mat_index: int = 0


@dataclasses.dataclass
class Instance:
    """TLAS instance: object index + world transform
    (hello_vulkan.cpp:668-687; `instanceCustomIndex = objIndex`)."""

    obj_index: int
    transform: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=F32))


@dataclasses.dataclass
class SceneDef:
    """Host scene graph: models + instances, the analog of the reference's
    `loadModel` call sequence (VKT/ray_tracing__before/main.cpp:200-212)."""

    models: list = dataclasses.field(default_factory=list)      # TriangleMesh | Torus
    instances: list = dataclasses.field(default_factory=list)   # Instance

    def add_model(self, model, transform: Optional[np.ndarray] = None) -> int:
        """Mirror of `HelloVulkan::loadModel(file, transform)`
        (hello_vulkan.cpp:190-247): registers the model and one instance."""
        idx = len(self.models)
        self.models.append(model)
        self.instances.append(Instance(
            obj_index=idx,
            transform=(np.eye(4, dtype=F32) if transform is None
                       else np.asarray(transform, dtype=F32))))
        return idx

    def add_instance(self, obj_index: int, transform: np.ndarray) -> int:
        self.instances.append(Instance(
            obj_index=obj_index, transform=np.asarray(transform, dtype=F32)))
        return len(self.instances) - 1


# ---------------------------------------------------------------------------
# Trace-ready scene (tensors)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TriangleSoup:
    """Flattened world-space triangles, padded to T rows (clusters).

    Woop transform per triangle: with `oh = [o, 1]`, component k of the
    transformed origin is `oh @ woop_o[k]` and of the direction
    `d @ woop_d[k]`; then t = -o'z/d'z, u = o'x + t d'x, v = o'y + t d'y and
    the hit test is u>=0, v>=0, u+v<=1 (Woop et al. unit-triangle test)."""

    v0: torch.Tensor           # (T, 3) f32
    e1: torch.Tensor           # (T, 3) f32  (v1 - v0)
    e2: torch.Tensor           # (T, 3) f32  (v2 - v0)
    n0: torch.Tensor           # (T, 3) f32  vertex normals (world space)
    n1: torch.Tensor
    n2: torch.Tensor
    uv0: torch.Tensor          # (T, 2)
    uv1: torch.Tensor
    uv2: torch.Tensor
    c0: torch.Tensor           # (T, 3) per-vertex colors (carried for ABI
    c1: torch.Tensor           #   parity; the reference's RT path never
    c2: torch.Tensor           #   samples them either)
    mat_id: torch.Tensor       # (T,) i32 into the global material table
    instance_id: torch.Tensor  # (T,) i32 (instanceCustomIndex analog)
    valid: torch.Tensor        # (T,) bool — False for padding rows
    woop_o: torch.Tensor       # (3, 4, T) f32
    woop_d: torch.Tensor       # (3, 3, T) f32

    @property
    def count(self) -> int:
        return int(self.v0.shape[0])


@dataclasses.dataclass
class TorusSoup:
    """Batch of analytic tori (world transforms kept explicit — the TLAS
    analog for procedural AABB instances)."""

    world_to_obj: torch.Tensor   # (K, 3, 4) f32
    obj_to_world: torch.Tensor   # (K, 3, 4) f32
    major_radius: torch.Tensor   # (K,) f32
    minor_radius: torch.Tensor   # (K,) f32 (< 0 on padding rows: never hit)
    mat_id: torch.Tensor         # (K,) i32
    instance_id: torch.Tensor    # (K,) i32
    valid: torch.Tensor          # (K,) bool
    center: torch.Tensor         # (K, 3) f32 world-space center
    bound_radius: torch.Tensor   # (K,) f32 world bounding-sphere radius

    @property
    def count(self) -> int:
        return int(self.major_radius.shape[0])


@dataclasses.dataclass
class TextureAtlas:
    """All scene textures + full mip chains in one flat texel buffer (the
    `sampler2D textureSamplers[]` binding, raytrace.rchit:22; mips as
    nvvk::cmdGenerateMipmaps, hello_vulkan.cpp:339). A single white texel
    if the scene has none (hello_vulkan.cpp:292-309).

    Level l of texture i occupies rows `offsets[i, l] : offsets[i, l] + h*w`
    with (h, w) = sizes[i, l]; levels past n_levels[i] repeat the last one.
    Row t of `data4q` holds the wrap-addressed 2x2 quad whose top-left
    texel is t, as sRGB u8 taps [t00, t10, t01, t11] in bytes 0-3 of each
    channel's 32-bit word (the reference's VK_FORMAT_R8G8B8A8_SRGB
    precision, hello_vulkan.cpp:289). The words are stored in int32
    tensors with the same bits."""

    offsets: torch.Tensor   # (n_tex, L) i32
    sizes: torch.Tensor     # (n_tex, L, 2) i32 — (height, width) per level
    n_levels: torch.Tensor  # (n_tex,) i32
    data4q: torch.Tensor    # (total_texels, 3) i32 bits of the packed u32 words

    @property
    def data4(self) -> torch.Tensor:
        """(total_texels, 12) linear-f32 quad view (tap-major: t00 rgb,
        t10 rgb, t01 rgb, t11 rgb), decoded on demand."""
        return torch.cat([tex_dequant(self.data4q, tap) for tap in range(4)],
                         dim=-1)

    @property
    def data(self) -> torch.Tensor:
        """(total_texels, 3) linear-f32 texel table view (top-left tap)."""
        return tex_dequant(self.data4q, 0)


# the sRGB decode of every byte value, (b / 255) ** 2.2 rounded as NumPy's
# float32 power rounds it: a table gives every device the same bits
_SRGB_DECODE = (np.arange(256, dtype=F32) * F32(1.0 / 255.0)) ** F32(2.2)
_srgb_tables: dict = {}


def srgb_table(device) -> torch.Tensor:
    """The (256,) f32 sRGB decode table on `device`, made once a device."""
    device = torch.device(device)
    table = _srgb_tables.get(device)
    if table is None:
        table = _srgb_tables[device] = torch.from_numpy(_SRGB_DECODE).to(
            device)
    return table


def tex_dequant(words: torch.Tensor, tap: int) -> torch.Tensor:
    """Byte `tap` of packed channel words -> linear f32 in [0, 1]: the
    sampler's sRGB decode (gamma 2.2), a 256-entry table lookup. Arithmetic
    right shift of the int32 bits is harmless: the mask keeps only the
    byte."""
    table = srgb_table(words.device)
    b = (words >> (8 * tap)) & 0xFF
    return table.index_select(0, b.reshape(-1)).view(b.shape)


@dataclasses.dataclass
class Scene:
    """Fully flattened scene: what `traceRayEXT` + descriptor sets see.

    `cluster_lo/hi` are the AABBs of the fixed-size triangle clusters the
    host build sorted the triangle table into. `loose_tris` counts the
    spatially fat rows compacted to the table tail (whole tail clusters):
    the kernel backend tests them densely outside the triangle kernel."""

    triangles: TriangleSoup
    tori: TorusSoup
    materials: Material
    textures: TextureAtlas
    cluster_lo: torch.Tensor   # (C, 3) f32
    cluster_hi: torch.Tensor   # (C, 3) f32
    cluster_size: int = 128
    loose_tris: int = 0
    # tables the kernel backend derives from the scene, built at its first
    # query on a device and keyed by (name, device) (ops/trace_kernel.py);
    # the scene's copy made by `to` shares them
    kernel_tables: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    @property
    def num_triangles(self) -> int:
        return self.triangles.count

    @property
    def num_tori(self) -> int:
        return self.tori.count

    @property
    def device(self) -> torch.device:
        return self.cluster_lo.device

    def to(self, device) -> "Scene":
        """The `to_device` analog (and the JAX package's
        `_as_device_scene`): this scene's one copy on `device`, made at the
        first call and again only after a tensor of the scene changed
        (`derived`); the scene itself when it is there. The copy shares
        this scene's `kernel_tables`, so a scene rendered from the host on
        every call builds its kernel tables once."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if self.device == device:
            return self
        return derived(self, device, lambda: _copy_scene(self, device))


def _copy_scene(scene: Scene, device) -> Scene:
    """A new copy of `scene` on `device` sharing its `kernel_tables`."""
    moved = _to(scene, device)
    moved.kernel_tables = scene.kernel_tables
    return moved
