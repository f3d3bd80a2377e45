"""Launch geometry of the port's kernels, in checkable form.

Counterpart of ``repro/kernels/gridspec.py`` and the reference's
``*_kernel_model`` builders (``repro/kernels/dwconv2d.py:39``,
``pwconv.py:46``, ``separable_fused.py:87``, ``fused_mbconv.py:59``,
``se_epilogue.py:46``).  The reference's model is a Pallas grid and its
BlockSpecs; the Hopper kernels' is a CUDA launch: for each launch a
:class:`LaunchModel` holds

* the grid, the CTA size, the thread-block cluster (CTAs along x) and the
  dynamic shared memory, computed here as the kernel's own launch function
  computes them (``LaunchDims`` in ``csrc/common.cuh``; each library's
  ``<kernel>_launch_dims`` export returns the numbers its launch uses, and
  :func:`library_dims` reads them, which ``chip_smoke.py`` holds against
  these on the card);
* for each CTA (:class:`CtaWork`, from the ``.cu`` sources' index math) the
  output tile it writes and the input window it reads, and in a cluster the
  slice of the reduced channels each member sums.

``analysis/planlint.py`` enumerates these to prove the windows in bounds and
the tiles a partition of the output; ``analysis/launch_check.py`` holds the
launch to the card's limits.  :func:`segment_models` gives the launches a
chain segment makes, with the arguments the lowering and the wrappers
derive from its plan (the ``pwconv`` tile overrides of a ``KernelPolicy``
aside).  ``dwconv1d`` has no plan, and no model here.

Windows are in the coordinates of the input zero-padded as the kernel reads
it (SAME's pads top and left; the far edge as much as the VALID geometry
needs), and cover what the CTA's outputs inside the image need: the kernels
stage a whole tile's window with guarded copies that fill zeros past the
edges, and mask the outputs past them.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Optional, Tuple

import torch

from repro_torch.kernels import _build, blocking

#: The card's launch limits (compute capability 9.0): grid x, y, z; threads
#: a CTA; a portable thread-block cluster; dynamic shared memory a CTA may
#: opt into.
GRID_LIMITS = (2 ** 31 - 1, 65535, 65535)
MAX_THREADS = 1024
WARP = 32
MAX_CLUSTER = 8
MAX_SMEM = blocking.DEFAULT_SMEM_BUDGET
#: Largest box edge and row-pitch granule of a TMA tensor map.
TMA_MAX_BOX = 256
TMA_PITCH = 16

Box = Tuple[Tuple[int, int], ...]


@dataclasses.dataclass(frozen=True)
class CtaWork:
    """What one CTA does: ``out``, the output tile it writes, (lo, hi) per
    output dimension as its index math gives it (hi may pass the edge;
    the kernel masks those); ``window``, the input box its in-image outputs
    read; ``red``, in a cluster, the slice of the reduced dimension it
    sums (None where nothing is split)."""
    out: Box
    window: Box
    red: Optional[Tuple[int, int]] = None


@dataclasses.dataclass(frozen=True)
class LaunchModel:
    """One kernel launch.  ``grid``, ``block``, ``cluster`` (x, y, z),
    ``smem`` (dynamic bytes a CTA); ``out_shape`` the array it writes,
    ``in_shape`` the padded input it reads; ``work(x, y, z)`` the CTA at
    that grid index; ``reduce`` the extent of the dimension a cluster's
    members split (0: none).  ``library`` / ``library_args``: the export
    that reports the library's own launch.  ``tma``: for the ``tc``
    variant, each tensor map's row pitch in bytes and box (cols, rows).
    ``vector_note``: why a 16-byte vector path is not taken, if one is
    not."""
    name: str
    grid: Tuple[int, int, int]
    block: Tuple[int, int, int]
    cluster: Tuple[int, int, int]
    smem: int
    out_shape: Tuple[int, ...]
    in_shape: Tuple[int, ...]
    work: Callable[[int, int, int], CtaWork]
    reduce: int = 0
    library: str = ""
    library_args: tuple = ()
    tma: tuple = ()
    vector_note: str = ""

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    @property
    def threads(self) -> int:
        return self.block[0] * self.block[1] * self.block[2]

    def dims(self) -> tuple:
        """(grid, block, cluster, smem), as :func:`library_dims` gives
        them."""
        return self.grid, self.block, self.cluster, self.smem


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _code(dtype: torch.dtype) -> int:
    return _build.DTYPE_CODES[dtype]


def pads_of(hi: int, ho: int, hf: int, stride: int) -> Tuple[int, int]:
    """(before, after) zero rows a kernel reads around ``hi`` input rows to
    give ``ho`` outputs: SAME's split where the VALID window of ``ho``
    outputs is taller than the input, else none (VALID)."""
    p = max((ho - 1) * stride + hf - hi, 0)
    return p // 2, p - p // 2


def _window(lo: int, hi: int, extent: int, stride: int, k: int) -> tuple:
    """Input rows [start, stop) the outputs [lo, min(hi, extent)) read."""
    last = min(hi, extent) - 1
    return lo * stride, last * stride + k


# ---------------------------------------------------------------------------
# the kernels (each mirrors its wrapper's arguments and its .cu launch)
# ---------------------------------------------------------------------------

def dwconv2d_model(*, b: int, hi: int, wi: int, c: int, ho: int, wo: int,
                   hf: int, wf: int, stride: int, tile_h: int, tile_w: int,
                   cg: int, vec: int, dtype: torch.dtype) -> LaunchModel:
    """``csrc/dwconv2d.cu``: grid (spatial tiles, channel groups, images);
    CTA (x, y, z) owns output rows ``x // tiles_w * tile_h``, columns
    ``x % tiles_w * tile_w``, channels ``y * cg`` of image ``z``."""
    return _dw_tile_model(
        "dwconv2d", b=b, hi=hi, wi=wi, c=c, ho=ho, wo=wo, hf=hf, wf=wf,
        stride=stride, tile_h=tile_h, tile_w=tile_w, cg=cg, vec=vec,
        dtype=dtype,
        smem=blocking.dwconv2d_smem_bytes(tile_h, tile_w, cg, hf, wf, stride,
                                          dtype),
        library="dwconv2d",
        library_args=(b, c, ho, wo, hf, wf, stride, tile_h, tile_w, cg, vec,
                      _code(dtype)))


def _dw_tile_model(name, *, b, hi, wi, c, ho, wo, hf, wf, stride, tile_h,
                   tile_w, cg, vec, dtype, smem, library, library_args,
                   hpart_cse: int = 0) -> LaunchModel:
    """``csrc/dw_tile.cuh``'s grid, shared by ``dwconv2d`` and both
    ``dw_se`` passes.  ``hpart_cse``: the pooling pass, whose output is
    its row of the fp32 workspace ``(B, CTAs an image, cse)``."""
    tiles_w = _cdiv(wo, tile_w)
    tiles = _cdiv(ho, tile_h) * tiles_w
    groups = _cdiv(c, cg)
    pt, pb = pads_of(hi, ho, hf, stride)
    pl, pr = pads_of(wi, wo, wf, stride)
    in_shape = (b, hi + pt + pb, wi + pl + pr, c)

    def work(x: int, y: int, z: int) -> CtaWork:
        oh0, ow0, c0 = x // tiles_w * tile_h, x % tiles_w * tile_w, y * cg
        win = ((z, z + 1), _window(oh0, oh0 + tile_h, ho, stride, hf),
               _window(ow0, ow0 + tile_w, wo, stride, wf),
               (c0, min(c0 + cg, c)))
        if hpart_cse:
            return CtaWork(((z, z + 1), (y * tiles + x, y * tiles + x + 1),
                            (0, hpart_cse)), win)
        return CtaWork(((z, z + 1), (oh0, oh0 + tile_h), (ow0, ow0 + tile_w),
                        (c0, c0 + cg)), win)

    v = 16 // dtype.itemsize
    return LaunchModel(
        name=name, grid=(tiles, groups, b),
        block=(cg // vec * tile_h * (tile_w // blocking.DW_RUN), 1, 1),
        cluster=(1, 1, 1), smem=smem,
        out_shape=((b, tiles * groups, hpart_cse) if hpart_cse
                   else (b, ho, wo, c)),
        in_shape=in_shape, work=work, library=library,
        library_args=library_args,
        vector_note=("" if vec > 1 else
                     f"C = {c} is not a multiple of {v}: one channel a "
                     "thread, not a 16-byte vector"))


def dw_se_models(*, b: int, hi: int, wi: int, c: int, ho: int, wo: int,
                 hf: int, wf: int, stride: int, tile_h: int, tile_w: int,
                 cg: int, vec: int, c_se: int, dtype: torch.dtype) -> list:
    """``csrc/dw_se.cu``'s two passes on ``dwconv2d``'s grid: the pooling
    pass writes each CTA's share of the reduce FC to the workspace, the
    scaling pass the output."""
    out = []
    for pass_, name in ((1, "dw_se.pool"), (2, "dw_se.scale")):
        out.append(_dw_tile_model(
            name, b=b, hi=hi, wi=wi, c=c, ho=ho, wo=wo, hf=hf, wf=wf,
            stride=stride, tile_h=tile_h, tile_w=tile_w, cg=cg, vec=vec,
            dtype=dtype,
            smem=blocking.dw_se_smem_bytes(pass_, tile_h, tile_w, cg, hf, wf,
                                           stride, c_se, dtype),
            library="dw_se",
            library_args=(pass_, b, c, ho, wo, hf, wf, stride, tile_h,
                          tile_w, cg, vec, c_se, _code(dtype)),
            hpart_cse=c_se if pass_ == 1 else 0))
    return out


def pwconv_model(*, g: int, ci: int, co: int, variant: str, bg: int,
                 bco: int, bci: int, dtype: torch.dtype,
                 aligned: bool = True) -> LaunchModel:
    """``csrc/pwconv.cu``, one variant.  ``stream``: grid (cluster,
    ceil(Co / bco), ceil(G / bg)), clusters along x, rank r summing Ci rows
    ``[r * bci, (r + 1) * bci)``.  ``tc`` / ``simt``: grid (ceil(G / bg),
    ceil(Co / bco)), each CTA the whole reduction."""
    vi = blocking.PW_VARIANTS.index(variant)
    smem = blocking.pwconv_smem_bytes(variant, bg, bco, bci, ci)
    note = ""
    v = 16 // dtype.itemsize
    if variant == "stream":
        cluster = _cdiv(ci, bci)
        grid = (cluster, _cdiv(co, bco), _cdiv(g, bg))

        def work(x, y, z):
            g0, n0 = z * bg, y * bco
            return CtaWork(((g0, g0 + bg), (n0, n0 + bco)),
                           ((g0, min(g0 + bg, g)),
                            (x * bci, min((x + 1) * bci, ci))),
                           (x * bci, min((x + 1) * bci, ci)))

        block, clus = (256, 1, 1), (cluster, 1, 1)
        if blocking.pw_vector(co, dtype, aligned) == 1:
            note = (f"Co = {co} is not a multiple of {v}: w is read element "
                    "by element, not in 16-byte vectors")
    else:
        cluster = 1
        grid = (_cdiv(g, bg), _cdiv(co, bco), 1)

        def work(x, y, z):
            g0, n0 = x * bg, y * bco
            return CtaWork(((g0, g0 + bg), (n0, n0 + bco)),
                           ((g0, min(g0 + bg, g)), (0, ci)), (0, ci))

        block = ((bg // 64 * 128 + 32 if variant == "tc" else 256), 1, 1)
        clus = (1, 1, 1)
        if (variant == "simt" and dtype in (torch.bfloat16, torch.float16)
                and (ci % 8 or co % 8)):
            note = (f"{ci}->{co} in {str(dtype).removeprefix('torch.')}: "
                    "Ci and Co are not multiples of 8, so no 16-byte rows "
                    "for TMA; simt, not the tensor cores")
    tma = ()
    if variant == "tc":
        nb = dtype.itemsize
        tma = ((ci * nb, (64, bg)), (co * nb, (64, 64)))
    return LaunchModel(
        name=f"pwconv.{variant}", grid=grid, block=block, cluster=clus,
        smem=smem, out_shape=(g, co), in_shape=(g, ci), work=work,
        reduce=ci, library="pwconv",
        library_args=(g, ci, co, vi, bg, bco, bci, cluster), tma=tma,
        vector_note=note)


def separable_fused_model(*, b: int, hi: int, wi: int, ci: int, c: int,
                          co: int, ho: int, wo: int, hf: int, wf: int,
                          stride: int, slab_h: int, cb: int, cs: int,
                          panel: int, cluster: int, expand: bool,
                          dtype: torch.dtype) -> LaunchModel:
    """``csrc/separable_fused.cuh``: grid (cluster, slabs, images); the
    cluster at (slab y, image z) writes full-width rows ``[y * slab_h,
    ...)`` of every Co channel, rank r summing DW channels ``[r * cs,
    ...)``.  The 3-stage kernel reads all ``ci`` raw channels of its
    window, the 2-stage one its slice of C."""
    pt, pb = pads_of(hi, ho, hf, stride)
    pl, pr = pads_of(wi, wo, wf, stride)
    c_in = ci if expand else c
    wwin = _window(0, wo, wo, stride, wf)

    def work(x, y, z):
        oh0, c0 = y * slab_h, x * cs
        red = (c0, min(c0 + cs, c))
        return CtaWork(((z, z + 1), (oh0, oh0 + slab_h), (0, wo), (0, co)),
                       ((z, z + 1), _window(oh0, oh0 + slab_h, ho, stride,
                                            hf), wwin,
                        (0, ci) if expand else red), red)

    v = 16 // dtype.itemsize
    widths = (("the input", c_in), ("Co", co)) + ((("C", c),) if expand
                                                  else ())
    bad = [n for n, w in widths if w % v]
    return LaunchModel(
        name="separable_fused3" if expand else "separable_fused2",
        grid=(cluster, _cdiv(ho, slab_h), b), block=(256, 1, 1),
        cluster=(cluster, 1, 1),
        smem=blocking.separable_smem_bytes(
            ci=ci if expand else 0, c_slice=cs, cb=cb, panel=panel,
            cluster=cluster, slab_h=slab_h, wo=wo, hi=hi, wi=wi, hf=hf,
            wf=wf, stride=stride, tc=dtype == torch.bfloat16),
        out_shape=(b, ho, wo, co), in_shape=(b, hi + pt + pb, wi + pl + pr,
                                             c_in),
        work=work, reduce=c, library="separable_fused",
        library_args=(b, ci if expand else 0, cs, cb, panel, cluster, slab_h,
                      ho, wo, hi, wi, hf, wf, stride, int(expand),
                      _code(dtype)),
        vector_note=("" if not bad else
                     f"{', '.join(bad)} not a multiple of {v} channels: "
                     "copied element by element, not in 16-byte vectors"))


def fused_mbconv_model(*, b: int, hi: int, wi: int, ci: int, c: int,
                       co: int, ho: int, wo: int, hf: int, wf: int,
                       stride: int, slab_h: int, tile_w: int, cb: int,
                       cs: int, panel: int, cluster: int,
                       dtype: torch.dtype) -> LaunchModel:
    """``csrc/fused_mbconv.cu``: grid (cluster, tiles, images); the cluster
    at (tile y, image z) writes rows ``y // tiles_w * slab_h`` and columns
    ``y % tiles_w * tile_w`` of every Co channel, rank r summing
    conv-output channels ``[r * cs, ...)``; each reads all ``ci`` input
    channels of its window."""
    tiles_w = _cdiv(wo, tile_w)
    pt, pb = pads_of(hi, ho, hf, stride)
    pl, pr = pads_of(wi, wo, wf, stride)

    def work(x, y, z):
        oh0, ow0, c0 = y // tiles_w * slab_h, y % tiles_w * tile_w, x * cs
        return CtaWork(((z, z + 1), (oh0, oh0 + slab_h),
                        (ow0, ow0 + tile_w), (0, co)),
                       ((z, z + 1), _window(oh0, oh0 + slab_h, ho, stride,
                                            hf),
                        _window(ow0, ow0 + tile_w, wo, stride, wf), (0, ci)),
                       (c0, min(c0 + cs, c)))

    v = 16 // dtype.itemsize
    bad = [n for n, w in (("Ci", ci), ("C", c), ("Co", co)) if w % v]
    return LaunchModel(
        name="fused_mbconv",
        grid=(cluster, _cdiv(ho, slab_h) * tiles_w, b), block=(256, 1, 1),
        cluster=(cluster, 1, 1),
        smem=blocking.fused_mb_smem_bytes(
            ci=ci, c_slice=cs, cb=cb, panel=panel, slab_h=slab_h,
            tile_w=tile_w, hf=hf, wf=wf, stride=stride,
            tc=dtype == torch.bfloat16),
        out_shape=(b, ho, wo, co), in_shape=(b, hi + pt + pb, wi + pl + pr,
                                             ci),
        work=work, reduce=c, library="fused_mbconv",
        library_args=(b, ci, cs, cb, panel, cluster, slab_h, tile_w, ho, wo,
                      hf, wf, stride, _code(dtype)),
        vector_note=("" if not bad else
                     f"{', '.join(bad)} not a multiple of {v} channels: "
                     "copied element by element, not in 16-byte vectors"))


# ---------------------------------------------------------------------------
# a chain segment's launches
# ---------------------------------------------------------------------------

def _pw_launch(g: int, ci: int, co: int, plan, dtype: torch.dtype):
    """The ``pwconv`` launch the lowering makes at ``plan``: its variant and
    tile, the ``stream`` cluster splitting Ci by ``block_c``."""
    return pwconv_model(g=g, ci=ci, co=co, variant=plan.variant,
                        bg=plan.block_g, bco=plan.block_co,
                        bci=plan.block_c, dtype=dtype)


def segment_models(geom, plan, dtype: torch.dtype) -> list:
    """The launches a chain segment makes at ``plan``, on a stream of
    ``dtype``, with the arguments the lowering and the wrappers derive
    from the plan (``geom`` is ``autotune._SegGeom``): one for the fused
    kernels, ``dwconv2d`` and ``pwconv``, two for ``dw_se`` (its passes)
    and for ``se`` (its two FCs through ``pwconv`` at G = batch); none for
    ``mb``, the plain dense conv."""
    kind = geom.kind
    b = geom.batch
    if kind == "mb":
        return []
    if kind == "pw":
        return [_pw_launch(geom.g, geom.ci, geom.co, plan, dtype)]
    if kind == "se":
        return [_pw_launch(b, geom.c, geom.g,
                           blocking.plan_pwconv(b, geom.c, geom.g,
                                                dtype=dtype), dtype),
                _pw_launch(b, geom.g, geom.c,
                           blocking.plan_pwconv(b, geom.g, geom.c,
                                                dtype=dtype), dtype)]
    common = dict(b=b, hi=geom.hi, wi=geom.wi, ho=geom.ho, wo=geom.wo,
                  hf=geom.hf, wf=geom.wf, stride=geom.stride, dtype=dtype)
    if kind in ("fused2", "fused3"):
        cs = blocking.separable_slice(geom.c, plan.cluster)
        return [separable_fused_model(
            ci=geom.ci, c=geom.c, co=geom.co,
            slab_h=min(plan.slab_h, geom.ho), cb=min(plan.block_c, cs),
            cs=cs, panel=plan.block_co, cluster=_cdiv(geom.c, cs),
            expand=kind == "fused3", **common)]
    if kind == "fusedmb":
        cs = blocking.separable_slice(geom.c, plan.cluster)
        return [fused_mbconv_model(
            ci=geom.ci, c=geom.c, co=geom.co,
            slab_h=min(plan.slab_h, geom.ho),
            tile_w=min(plan.tile_w, geom.wo), cb=min(plan.block_c, cs),
            cs=cs, panel=plan.block_co, cluster=_cdiv(geom.c, cs),
            **common)]
    vec = blocking.dw_vector(geom.c, dtype)
    tile = dict(c=geom.c, tile_h=min(plan.slab_h, geom.ho),
                tile_w=plan.tile_w, cg=plan.block_c, vec=vec)
    if kind == "dw":
        return [dwconv2d_model(**tile, **common)]
    if kind == "dw_se":
        return dw_se_models(c_se=geom.g, **tile, **common)
    raise ValueError(f"unknown segment kind {kind!r}")


# ---------------------------------------------------------------------------
# the libraries' own launches (on a machine with nvcc)
# ---------------------------------------------------------------------------

def library_dims(model: LaunchModel) -> tuple:
    """(grid, block, cluster, smem) that ``model``'s library configures for
    the same launch (its ``<library>_launch_dims`` export: the function its
    launch calls).  Builds the library on first use."""
    lib = _build.library(model.library)
    fn = getattr(lib, f"{model.library}_launch_dims")
    out = (ctypes.c_longlong * 10)()
    fn.argtypes = ([ctypes.c_int] * len(model.library_args)
                   + [ctypes.POINTER(ctypes.c_longlong)])
    fn.restype = ctypes.c_int
    code = fn(*model.library_args, out)
    if code != 0:
        raise ValueError(f"{model.library}_launch_dims{model.library_args} "
                         f"returned {code}")
    v = list(out)
    return tuple(v[0:3]), tuple(v[3:6]), tuple(v[6:9]), v[9]
