"""The mesh ray-cast wrappers and their CUDA kernels (tiled and untiled).

The kernel runs only on an NVIDIA GPU with nvcc; those tests carry the
`cuda` marker and skip elsewhere (run them on the card with
`python -m pytest tests/test_torch_kernel.py -m cuda`). There the kernel
must equal its plain PyTorch version exactly: ids, t, u, v bit for bit
(-fmad=false and the same operation order, csrc/mesh_raycast.cu). This
file imports only torch and the port, so it also collects where the
repository's test helpers do not import.
"""

import pytest
import torch

from nerf_glasses_tpu_torch.ops import mesh_cuda

torch.set_num_threads(1)


def _inputs(n_tris, n_tiles, tile_rays, seed=0, device="cpu"):
    """Random triangles (both windings) around the origin, rays from z=2
    toward them, per-tile ascending candidate lists with counts from 0 to
    n_tris."""
    g = torch.Generator().manual_seed(seed)
    v0 = torch.rand(n_tris, 3, generator=g) - 0.5
    e1 = (torch.rand(n_tris, 3, generator=g) - 0.5) * 0.3
    e2 = (torch.rand(n_tris, 3, generator=g) - 0.5) * 0.3
    # triangle 0 faces the rays and covers a part of them
    v0[0], e1[0], e2[0] = (torch.tensor([-0.5, -0.5, 0.0]),
                           torch.tensor([1.0, 0.0, 0.0]),
                           torch.tensor([0.0, 1.0, 0.0]))
    o = torch.zeros(n_tiles * tile_rays, 3)
    o[:, 2] = 2.0
    d = torch.randn(n_tiles * tile_rays, 3, generator=g) * 0.25
    d[:, 2] = -1.0
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    counts = torch.randint(0, n_tris + 1, (n_tiles,), generator=g,
                           dtype=torch.int32)
    counts[0], counts[-1] = 0, n_tris
    lists = torch.sort(torch.stack([torch.randperm(n_tris, generator=g)
                                    for _ in range(n_tiles)]), dim=1).values
    return [x.to(device).contiguous() for x in
            (torch.cat([v0, e1, e2], 1), o, d, lists.int(), counts)]


def test_cpu_tensors_take_the_plain_version():
    args = _inputs(40, 3, 64)
    before = mesh_cuda.launches
    t, i, u, v = mesh_cuda.raycast_tiled(*args)
    assert mesh_cuda.launches == before
    assert (i >= 0).sum() > 0 and i.dtype == torch.int32
    assert (t[i < 0] == mesh_cuda.BIG).all()


def test_wrapper_rejects_what_the_kernel_does_not_take():
    args = _inputs(40, 3, 64)
    with pytest.raises(ValueError):
        mesh_cuda.raycast_tiled(*(a.to("meta") for a in args))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3000, 40, 8192), (500, 7, 1000), (1, 2, 256)],
                         ids=["main_path_tiles", "partial_blocks", "one_triangle"])
def test_kernel_matches_plain_on_card(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run: pytest -m cuda)")
    args = _inputs(*shape, device="cuda")
    before = mesh_cuda.launches
    out_k = mesh_cuda.raycast_tiled(*args)
    torch.cuda.synchronize()
    assert mesh_cuda.launches == before + 1
    out_p = mesh_cuda.raycast_tiled_reference(*args)
    assert (out_p[1] >= 0).sum() > 0
    for k, p in zip(out_k, out_p):
        assert torch.equal(k, p)


@pytest.mark.cuda
def test_kernel_rejects_bad_shapes_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run: pytest -m cuda)")
    tri, o, d, lists, counts = _inputs(10, 2, 64, device="cuda")
    with pytest.raises(ValueError):
        mesh_cuda.raycast_tiled(tri, o[:-1], d[:-1], lists, counts)
    with pytest.raises(ValueError):
        mesh_cuda.raycast_tiled(tri, o, d, lists.long(), counts)


# ---------------------------------------------------------------------------
# The untiled ray-cast (raycast, kernel nmr_raycast)
# ---------------------------------------------------------------------------

def _untiled_inputs(n_tris, n_rays, seed=1, device="cpu"):
    tri, o, d, _, _ = _inputs(max(n_tris, 1), 1, n_rays, seed)
    return [x.to(device).contiguous() for x in (tri[:n_tris], o, d)]


def test_untiled_cpu_tensors_take_the_plain_version():
    args = _untiled_inputs(40, 500)
    before = mesh_cuda.raycast_launches
    t, i, u, v = mesh_cuda.raycast(*args)
    assert mesh_cuda.raycast_launches == before
    assert (i >= 0).sum() > 0 and i.dtype == torch.int32
    assert (t[i < 0] == mesh_cuda.BIG).all()
    # every ray against all triangles == one tile holding every triangle
    tile = mesh_cuda.raycast_tiled(
        *args, torch.arange(40, dtype=torch.int32)[None],
        torch.tensor([40], dtype=torch.int32))
    for a, b in zip((t, i, u, v), tile):
        assert torch.equal(a, b)


def test_untiled_wrapper_rejects_what_the_kernel_does_not_take():
    args = _untiled_inputs(40, 64)
    with pytest.raises(ValueError):
        mesh_cuda.raycast(*(a.to("meta") for a in args))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3280, 65536), (700, 1000), (1, 257),
                                   (0, 64)],
                         ids=["glasses_size", "partial_batch",
                              "one_triangle", "no_triangles"])
def test_untiled_kernel_matches_plain_on_card(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run: pytest -m cuda)")
    args = _untiled_inputs(*shape, device="cuda")
    before = mesh_cuda.raycast_launches
    out_k = mesh_cuda.raycast(*args)
    torch.cuda.synchronize()
    assert mesh_cuda.raycast_launches == before + 1
    out_p = mesh_cuda.raycast_reference(*args)
    assert (out_p[1] >= 0).sum() > 0 or shape[0] == 0
    for k, p in zip(out_k, out_p):
        assert torch.equal(k, p)


@pytest.mark.cuda
def test_untiled_kernel_rejects_bad_shapes_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run: pytest -m cuda)")
    tri, o, d = _untiled_inputs(10, 64, device="cuda")
    with pytest.raises(ValueError):
        mesh_cuda.raycast(tri, o[:-1], d)
    with pytest.raises(ValueError):
        mesh_cuda.raycast(tri[:, :8].contiguous(), o, d)
