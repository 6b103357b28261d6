"""glTF 2.0 subset loader (pure Python, no tinygltf).

Loads the subset the reference renderer consumes
(reference: src/gltf_scene.cpp:63-216 — node TRS trees, u16/u32 indices,
POSITION/NORMAL/TANGENT/TEXCOORD_0 accessors, PBR metallic-roughness
materials with baseColor/metallicRoughness/normal/occlusion/emissive
textures). Missing tangents are generated per-triangle from UVs and
area-averaged per vertex (stand-in for MikkTSpace,
gltf_mikktspace_handler.cpp). Missing/broken texture files degrade to
factors only.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import os
import struct
from typing import List, Optional

import numpy as np

from nerf_glasses_tpu_torch.utils.quat import quat_to_mat3

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
                "MAT3": 9, "MAT4": 16}


@dataclasses.dataclass
class GltfMaterial:
    name: str = ""
    base_color_factor: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(4, np.float32))
    base_color_texture: Optional[np.ndarray] = None       # (H,W,4) f32 linear
    metallic_factor: float = 1.0
    roughness_factor: float = 1.0
    metallic_roughness_texture: Optional[np.ndarray] = None
    emissive_factor: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    emissive_texture: Optional[np.ndarray] = None
    normal_scale: float = 1.0
    normal_texture: Optional[np.ndarray] = None
    occlusion_strength: float = 1.0
    occlusion_texture: Optional[np.ndarray] = None


@dataclasses.dataclass
class GltfPrimitive:
    positions: np.ndarray       # (V, 3) f32
    normals: np.ndarray         # (V, 3) f32
    tangents: np.ndarray        # (V, 4) f32
    texcoords: np.ndarray       # (V, 2) f32
    indices: np.ndarray         # (M,) uint32
    material: GltfMaterial


@dataclasses.dataclass
class GltfMesh:
    primitives: List[GltfPrimitive] = dataclasses.field(default_factory=list)

    # pynmr exposes mesh.meshPrimitives
    @property
    def meshPrimitives(self):
        return self.primitives


class GltfNode:
    """Scene node with TRS; exposes the pynmr-visible surface
    (python_api.cu:273-277: scale / translation read-write)."""

    def __init__(self):
        self.name = ""
        self.mesh: Optional[GltfMesh] = None
        self.children: List["GltfNode"] = []
        self.translation = np.zeros(3, np.float32)
        self.rotation = np.array([1.0, 0, 0, 0], np.float32)  # (w,x,y,z)
        self.scale = np.ones(3, np.float32)
        self._facing_cache = None
        self._facing_dir = None

    def get_transform(self) -> np.ndarray:
        """T @ R @ S as 4x4 (gltf_scene.h:122-127)."""
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = (quat_to_mat3(self.rotation)
                     @ np.diag(self.scale)).astype(np.float32)
        m[:3, 3] = self.translation
        return m

    def centroid(self) -> np.ndarray:
        """Volume-weighted centroid of the first primitive's triangles
        (gltf_scene.h:131-145 — note the reference iterates positions in
        storage order; we use the index buffer, which is equivalent for
        de-indexed meshes and correct otherwise)."""
        prim = self.mesh.primitives[0]
        tris = prim.positions[prim.indices.reshape(-1, 3)]
        v1, v2, v3 = tris[:, 0], tris[:, 1], tris[:, 2]
        centers = (v1 + v2 + v3) / 4.0
        volumes = np.einsum("ij,ij->i", v1, np.cross(v2, v3)) / 6.0
        total = volumes.sum()
        if abs(total) < 1e-12:  # flat/degenerate mesh: fall back to mean
            return prim.positions.mean(axis=0)
        return (centers * volumes[:, None]).sum(axis=0) / total

    def vertices_facing_direction(self, direction: np.ndarray) -> np.ndarray:
        """Unique local-space vertices whose rotated normal faces `direction`
        (dot < 0), over this node and children (gltf_scene.h:147-171)."""
        direction = np.asarray(direction, np.float32)
        if (self._facing_dir is not None
                and np.allclose(direction, self._facing_dir, atol=1e-3)):
            return self._facing_cache
        r = quat_to_mat3(self.rotation).astype(np.float32)
        out = []
        if self.mesh is not None:
            for prim in self.mesh.primitives:
                n_rot = prim.normals @ r.T
                mask = (n_rot * direction).sum(-1) < 0
                out.append(prim.positions[mask])
        for child in self.children:
            out.append(child.vertices_facing_direction(direction))
        verts = np.concatenate(out, axis=0) if out else np.zeros((0, 3), np.float32)
        # dedupe at 0.01 resolution (KeyFuncs epsilon, gltf_scene.h:92-103)
        if len(verts):
            key = np.round(verts / 0.01).astype(np.int64)
            _, idx = np.unique(key, axis=0, return_index=True)
            verts = verts[np.sort(idx)]
        self._facing_dir = direction
        self._facing_cache = verts
        return verts

    def rotate_around_axis(self, axis, local_point, angle_degrees: float):
        """Rotate the node around an axis through a mesh-local point so
        that point stays fixed (GltfNode::RotateAroundAxis,
        gltf_scene.cpp:366-372):
            p = R_node * (scale * localPoint)
            translation += p - R_delta * p;  rotation = R_delta * rotation
        """
        from nerf_glasses_tpu_torch.utils.quat import (quat_from_axis_angle,
                                                 quat_multiply,
                                                 quat_normalize, quat_to_mat3)
        dq = quat_from_axis_angle(axis, np.deg2rad(angle_degrees))
        p = quat_to_mat3(self.rotation) @ (
            self.scale * np.asarray(local_point, np.float64))
        self.translation = (self.translation
                            + (p - quat_to_mat3(dq) @ p)).astype(np.float32)
        self.rotation = quat_normalize(
            quat_multiply(dq, self.rotation)).astype(np.float32)

    # reference-name aliases
    getTransform = get_transform
    getVerticesFacingDirection = vertices_facing_direction
    RotateAroundAxis = rotate_around_axis


class GltfScene:
    def __init__(self):
        self.name = ""
        self.nodes: List[GltfNode] = []

    def get_name(self) -> str:
        if self.name:
            return self.name
        if self.nodes and self.nodes[0].name:
            return self.nodes[0].name
        return "Scene"

    def get_mesh_primitives(self) -> List[GltfPrimitive]:
        prims = []
        stack = list(self.nodes)
        while stack:
            n = stack.pop()
            if n.mesh is not None:
                prims.extend(n.mesh.primitives)
            stack.extend(n.children)
        return prims

    def get_transform(self) -> np.ndarray:
        return self.nodes[0].get_transform() if self.nodes else np.eye(4, dtype=np.float32)


# ---------------------------------------------------------------------------
# Loader
# ---------------------------------------------------------------------------

def load(path: str) -> GltfScene:
    base = os.path.dirname(os.path.abspath(path))
    with open(path, "rb") as f:
        head = f.read(4)
    if head == b"glTF":
        doc, buffers = _load_glb(path)
    else:
        with open(path) as f:
            doc = json.load(f)
        buffers = [_load_buffer(b, base) for b in doc.get("buffers", [])]

    textures = _load_textures(doc, base, buffers)
    materials = [_load_material(m, textures) for m in doc.get("materials", [])]

    def accessor(idx: int) -> np.ndarray:
        acc = doc["accessors"][idx]
        view = doc["bufferViews"][acc["bufferView"]]
        buf = buffers[view["buffer"]]
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        ncomp = _TYPE_COUNTS[acc["type"]]
        count = acc["count"]
        offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = view.get("byteStride") or (np.dtype(dtype).itemsize * ncomp)
        itemsize = np.dtype(dtype).itemsize
        if stride == itemsize * ncomp:
            arr = np.frombuffer(buf, dtype, count * ncomp, offset)
            return arr.reshape(count, ncomp) if ncomp > 1 else arr
        rows = np.lib.stride_tricks.as_strided(
            np.frombuffer(buf, np.uint8, count * stride, offset),
            (count, ncomp * itemsize), (stride, 1))
        return rows.copy().view(dtype).reshape(count, ncomp)

    def load_mesh(mesh_idx: int) -> GltfMesh:
        mesh = GltfMesh()
        for prim in doc["meshes"][mesh_idx]["primitives"]:
            attrs = prim["attributes"]
            positions = accessor(attrs["POSITION"]).astype(np.float32)
            v = len(positions)
            indices = (accessor(prim["indices"]).reshape(-1).astype(np.uint32)
                       if "indices" in prim
                       else np.arange(v, dtype=np.uint32))
            normals = (accessor(attrs["NORMAL"]).astype(np.float32)
                       if "NORMAL" in attrs
                       else _face_normals(positions, indices))
            texcoords = (accessor(attrs["TEXCOORD_0"]).astype(np.float32)
                         if "TEXCOORD_0" in attrs
                         else np.zeros((v, 2), np.float32))
            tangents = (accessor(attrs["TANGENT"]).astype(np.float32)
                        if "TANGENT" in attrs
                        else _generate_tangents(positions, normals,
                                                texcoords, indices))
            mat = (materials[prim["material"]] if "material" in prim
                   else GltfMaterial())
            mesh.primitives.append(GltfPrimitive(
                positions, normals, tangents, texcoords, indices, mat))
        return mesh

    def traverse(node_idx: int) -> GltfNode:
        jn = doc["nodes"][node_idx]
        node = GltfNode()
        node.name = jn.get("name", "")
        if "translation" in jn:
            node.translation = np.asarray(jn["translation"], np.float32)
        if "rotation" in jn:
            x, y, z, w = jn["rotation"]   # glTF stores (x, y, z, w)
            node.rotation = np.array([w, x, y, z], np.float32)
        if "scale" in jn:
            node.scale = np.asarray(jn["scale"], np.float32)
        if "mesh" in jn:
            node.mesh = load_mesh(jn["mesh"])
        for c in jn.get("children", []):
            node.children.append(traverse(c))
        return node

    scene = GltfScene()
    sc = doc["scenes"][doc.get("scene", 0)]
    scene.name = sc.get("name", "")
    for n in sc.get("nodes", []):
        scene.nodes.append(traverse(n))
    return scene


def _load_glb(path: str):
    with open(path, "rb") as f:
        data = f.read()
    magic, version, length = struct.unpack_from("<4sII", data, 0)
    off = 12
    doc = None
    buffers = []
    while off < length:
        clen, ctype = struct.unpack_from("<II", data, off)
        off += 8
        chunk = data[off:off + clen]
        off += clen
        if ctype == 0x4E4F534A:  # JSON
            doc = json.loads(chunk)
        elif ctype == 0x004E4942:  # BIN
            buffers.append(chunk)
    return doc, buffers


def _load_buffer(jbuf: dict, base: str) -> bytes:
    uri = jbuf.get("uri", "")
    if uri.startswith("data:"):
        return base64.b64decode(uri.split(",", 1)[1])
    with open(os.path.join(base, uri), "rb") as f:
        return f.read()


def _load_textures(doc, base, buffers):
    out = []
    for tex in doc.get("textures", []):
        img = doc["images"][tex["source"]]
        arr = None
        try:
            from PIL import Image
            import io as _io
            if "uri" in img and not img["uri"].startswith("data:"):
                pil = Image.open(os.path.join(base, img["uri"]))
            elif "uri" in img:
                pil = Image.open(_io.BytesIO(
                    base64.b64decode(img["uri"].split(",", 1)[1])))
            else:
                view = doc["bufferViews"][img["bufferView"]]
                buf = buffers[view["buffer"]]
                o = view.get("byteOffset", 0)
                pil = Image.open(_io.BytesIO(buf[o:o + view["byteLength"]]))
            arr = np.asarray(pil.convert("RGBA"), np.float32) / 255.0
        except Exception:
            arr = None  # e.g. git-lfs stub — degrade to material factors
        out.append(arr)
    return out


def _srgb_to_linear(x):
    return np.where(x <= 0.04045, x / 12.92,
                    np.power((x + 0.055) / 1.055, 2.4)).astype(np.float32)


def _load_material(jm: dict, textures) -> GltfMaterial:
    mat = GltfMaterial(name=jm.get("name", ""))
    pbr = jm.get("pbrMetallicRoughness", {})
    if "baseColorFactor" in pbr:
        mat.base_color_factor = np.asarray(pbr["baseColorFactor"], np.float32)
    mat.metallic_factor = float(pbr.get("metallicFactor", 1.0))
    mat.roughness_factor = float(pbr.get("roughnessFactor", 1.0))

    def tex(slot):
        if slot is None:
            return None
        t = textures[slot["index"]]
        return t

    def tex_srgb(slot):
        t = tex(slot)
        if t is None:
            return None
        # baseColor/emissive textures are sRGB-encoded (gltf_scene.cpp:161-216)
        out = t.copy()
        out[..., :3] = _srgb_to_linear(out[..., :3])
        return out

    mat.base_color_texture = tex_srgb(pbr.get("baseColorTexture"))
    mat.metallic_roughness_texture = tex(pbr.get("metallicRoughnessTexture"))
    mat.emissive_texture = tex_srgb(jm.get("emissiveTexture"))
    if "emissiveFactor" in jm:
        mat.emissive_factor = np.asarray(jm["emissiveFactor"], np.float32)
    nt = jm.get("normalTexture")
    if nt is not None:
        mat.normal_texture = tex(nt)
        mat.normal_scale = float(nt.get("scale", 1.0))
    ot = jm.get("occlusionTexture")
    if ot is not None:
        mat.occlusion_texture = tex(ot)
        mat.occlusion_strength = float(ot.get("strength", 1.0))
    return mat


def _face_normals(positions, indices) -> np.ndarray:
    tri = indices.reshape(-1, 3)
    e1 = positions[tri[:, 1]] - positions[tri[:, 0]]
    e2 = positions[tri[:, 2]] - positions[tri[:, 0]]
    fn = np.cross(e1, e2)
    out = np.zeros_like(positions)
    for k in range(3):
        np.add.at(out, tri[:, k], fn)
    norm = np.linalg.norm(out, axis=-1, keepdims=True)
    return (out / np.maximum(norm, 1e-12)).astype(np.float32)


def _generate_tangents(positions, normals, texcoords, indices) -> np.ndarray:
    """UV-gradient tangents, area-accumulated per vertex, then
    Gram-Schmidt orthogonalized against the normal. Substitute for
    MikkTSpace (gltf_scene.cpp:154)."""
    tri = indices.reshape(-1, 3)
    p0, p1, p2 = (positions[tri[:, k]] for k in range(3))
    uv0, uv1, uv2 = (texcoords[tri[:, k]] for k in range(3))
    e1, e2 = p1 - p0, p2 - p0
    duv1, duv2 = uv1 - uv0, uv2 - uv0
    det = duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1]
    r = np.where(np.abs(det) > 1e-12, 1.0 / np.where(det == 0, 1, det), 0.0)
    tang = (e1 * duv2[:, 1:2] - e2 * duv1[:, 1:2]) * r[:, None]
    acc = np.zeros_like(positions)
    for k in range(3):
        np.add.at(acc, tri[:, k], tang)
    t = acc - normals * np.einsum("ij,ij->i", normals, acc)[:, None]
    norm = np.linalg.norm(t, axis=-1, keepdims=True)
    fallback = np.tile(np.array([1.0, 0.0, 0.0], np.float32), (len(t), 1))
    t = np.where(norm > 1e-8, t / np.maximum(norm, 1e-12), fallback)
    return np.concatenate(
        [t, np.ones((len(t), 1), np.float32)], axis=-1).astype(np.float32)
