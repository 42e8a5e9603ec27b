"""The paper's worked examples as HFAV programs.

The port's copy of ``repro.core.programs``: the same 15 programs, rules
and kernel bodies, and three programs of the port's own
(:data:`PORT_ONLY`): :func:`~repro_torch.core.hydro2d.hydro2d_program`,
HydroC's whole split step, and the two of HydroC's time loop
(:mod:`repro_torch.core.hydroc`): ``courant``, the reduction that gives
``dt / dx``, and ``hydroc``, the split step reading ``dt / dx`` as a
scalar input.  The bodies call ``where``/``sqrt`` from
:mod:`repro_torch.core.elementwise` instead of ``jnp``, so one body runs
eagerly on torch tensors and lowers to C under the CUDA emitter.

* :func:`laplace5_program` — the 5-point Laplace stencil of Listing 1 /
  Fig. 2 (interior update over an N x N grid).
* :func:`normalization_program` — the flux-normalization example of
  Fig. 3/4/6 and Section 5.2: per-cell flux, global L2 norm (a reduction),
  then per-cell normalization (a broadcast of the norm).  Fuses to exactly
  TWO loop nests (the reduction->broadcast concave-dataflow split).
* :func:`cosmo_program` — the COSMO fourth-order diffusion micro-kernels of
  Section 5.3: ulapstage -> flux_x / flux_y -> ustage over (k, j, i) with
  no k dependencies.  HFAV contracts the Laplacian to a 3-row and the
  fluxes to 2-row rolling buffers.
* :func:`hydro1d_program` — a dimensionally-split Godunov-style pass in the
  spirit of Hydro2D's nine kernels (Section 5.4), simplified to a single
  conserved system sweep: primitive conversion, EOS, slope limiting, trace,
  Riemann solve at interfaces, flux, conservative update.

Executor coverage programs (one per lifted Pallas restriction — see
docs/BACKENDS.md):

* :func:`pyramid4d_program` — a two-stage blur/edge pipeline over a 4-D
  ``(l, k, j, i)`` loop order: two outer identifiers flatten onto leading
  Pallas grid dims, with the blur contracted to a 3-row rolling buffer.
* :func:`energy3d_program` — a global L2 energy over ``(k, j, i)``: a
  k-tiled reduction whose VMEM accumulator row is carried across every
  outer tile of the 2-D ``(k, j)`` grid.
* :func:`plane_sum_program` — per-plane sums ``colsum[k] = sum_{j,i}``:
  a reduction keeping the outer dim, realized as a per-tile accumulator
  re-initialized at each k.
* :func:`smooth_norm_program` — a normalization variant whose roughness
  kernel reads the flux at rows j and j-1 *inside the producing nest*
  while the flux also crosses the reduction split: the cross-row read of
  a same-nest materialized variable.
* :func:`heat3d_program` — the 7-point 3-D heat stencil: ``u[k-1]`` /
  ``u[k+1]`` reads put a stencil offset in an *outer* dim, served by a
  3-plane VMEM window carried across the k grid (with the non-exact
  outer extents the halo induces).
* :func:`advect4d_halo_program` — a k-upwind advection over a 4-D
  ``(l, k, j, i)`` order: a plane window riding a grid with two outer
  dims (``u[l][k+1][j][i]``-style reads).
* :func:`row_sum_program` — row sums ``rsum[j] = sum_i``: a reduction
  keeping the row dim (reduced dims = the vector dim only), emitted as
  per-step partial-accumulator rows lane-reduced on the host.
* :func:`subset_sum_program` — ``(l, k, j, i) -> lsum[l]``: a reduction
  keeping a strict leading subset of the outer dims, with the VMEM
  accumulator re-initialized per kept-prefix tile.

Every kernel body is a pure elementwise function over rows — the
engine's unfused references (used by tests/benchmarks) call the same
bodies, so fused-vs-unfused comparisons share arithmetic exactly.
Every kernel body is also a *module-level* function, so serialized
KernelPlans re-link them by importable reference
(``repro_torch.core.plan.fn_to_spec``) — keep it that way when adding
programs, or register closures via ``register_step_builder``.

:data:`ALL_PROGRAMS` maps every program name to its builder; it drives
the golden-plan corpus (``tests/goldens/plans/``), the AOT cache
warmer (``scripts/warm_cache.py``) and parametrized tests.
"""
from __future__ import annotations

from .elementwise import sqrt, where
from .hydro2d import hydro2d_program, hydroc_program
from .hydroc import courant_program
from .rules import Program, axiom, goal, kernel


# ---------------------------------------------------------------------------
# 5-point Laplace (SOR-style weighted update)
# ---------------------------------------------------------------------------

def _laplace5(n, e, s, w_, c):
    return 0.25 * (n + e + s + w_) - c


def laplace5_program(name: str = "laplace5") -> Program:
    k_lap = kernel(
        "laplace5",
        inputs=[
            ("n", "q?[j?-1][i?]"),
            ("e", "q?[j?][i?+1]"),
            ("s", "q?[j?+1][i?]"),
            ("w", "q?[j?][i?-1]"),
            ("c", "q?[j?][i?]"),
        ],
        outputs=[("o", "laplace(q?[j?][i?])")],
        fn=_laplace5,
    )
    return Program(
        rules=[k_lap],
        axioms=[axiom("cell[j?][i?]", j="Nj", i="Ni")],
        goals=[goal("laplace(cell[j][i])", store_as="lap",
                    j=("Nj", 1, -1), i=("Ni", 1, -1))],
        loop_order=("j", "i"),
        name=name,
    )


def _blur3(n, e, s, w_, c):
    return 0.125 * (n + e + s + w_) + 0.5 * c


def laplace_pair_program(name: str = "laplace_pair") -> Program:
    """Two terminal outputs sharing one fused nest: the 5-point Laplacian
    plus a cross-shaped blur over the same input windows.  Exercises
    multi-goal dispatch (multi-ref out specs on the Pallas backend)."""
    k_lap = kernel(
        "laplace5",
        inputs=[
            ("n", "q?[j?-1][i?]"),
            ("e", "q?[j?][i?+1]"),
            ("s", "q?[j?+1][i?]"),
            ("w", "q?[j?][i?-1]"),
            ("c", "q?[j?][i?]"),
        ],
        outputs=[("o", "laplace(q?[j?][i?])")],
        fn=_laplace5,
    )
    k_blur = kernel(
        "blur3",
        inputs=[
            ("n", "q?[j?-1][i?]"),
            ("e", "q?[j?][i?+1]"),
            ("s", "q?[j?+1][i?]"),
            ("w", "q?[j?][i?-1]"),
            ("c", "q?[j?][i?]"),
        ],
        outputs=[("o", "blur(q?[j?][i?])")],
        fn=_blur3,
    )
    return Program(
        rules=[k_lap, k_blur],
        axioms=[axiom("cell[j?][i?]", j="Nj", i="Ni")],
        goals=[
            goal("laplace(cell[j][i])", store_as="lap",
                 j=("Nj", 1, -1), i=("Ni", 1, -1)),
            goal("blur(cell[j][i])", store_as="blur",
                 j=("Nj", 1, -1), i=("Ni", 1, -1)),
        ],
        loop_order=("j", "i"),
        name=name,
    )


# ---------------------------------------------------------------------------
# Executor coverage: outer grids, k-tiled reductions, cross-row reads
# ---------------------------------------------------------------------------

def _edge3(m, c, p):
    return p + m - 2.0 * c


def pyramid4d_program(name: str = "pyramid4d") -> Program:
    """Blur -> vertical edge detect over a 4-D ``(l, k, j, i)`` space.

    Two outer loop identifiers (``l``: pyramid level, ``k``: channel)
    with no cross-dependencies — they flatten onto leading Pallas grid
    dims — while the edge kernel's ``j +/- 1`` reads of the blur force a
    3-row rolling buffer carried across the row grid dim."""
    k_blur = kernel(
        "blur5",
        inputs=[
            ("n", "u?[l?][k?][j?-1][i?]"),
            ("e", "u?[l?][k?][j?][i?+1]"),
            ("s", "u?[l?][k?][j?+1][i?]"),
            ("w", "u?[l?][k?][j?][i?-1]"),
            ("c", "u?[l?][k?][j?][i?]"),
        ],
        outputs=[("o", "blur(u?[l?][k?][j?][i?])")],
        fn=_blur3,
    )
    k_edge = kernel(
        "edge3",
        inputs=[
            ("m", "blur(u?[l?][k?][j?-1][i?])"),
            ("c", "blur(u?[l?][k?][j?][i?])"),
            ("p", "blur(u?[l?][k?][j?+1][i?])"),
        ],
        outputs=[("o", "edge(u?[l?][k?][j?][i?])")],
        fn=_edge3,
    )
    return Program(
        rules=[k_blur, k_edge],
        axioms=[axiom("u[l?][k?][j?][i?]", l="Nl", k="Nk", j="Nj", i="Ni")],
        goals=[goal("edge(u[l][k][j][i])", store_as="edge",
                    l=("Nl", 0, 0), k=("Nk", 0, 0),
                    j=("Nj", 2, -2), i=("Ni", 1, -1))],
        loop_order=("l", "k", "j", "i"),
        name=name,
    )


def _sq1(a):
    return a * a


def _sum2(acc, x):
    return acc + x


def energy3d_program(name: str = "energy3d") -> Program:
    """Global L2 energy of a 3-D field: ``energy = sum_{k,j,i} u^2``.

    A k-tiled reduction — the grid is ``(k, j)`` and the vector partial
    accumulator is carried across *every* outer tile, then lane-reduced
    on the host."""
    k_sq = kernel("sq", [("a", "u?[k?][j?][i?]")],
                  [("o", "sq(u?[k?][j?][i?])")], fn=_sq1)
    k_sum = kernel("energy_sum", [("x", "sq(u[k][j][i])")],
                   [("acc", "energy(u)")], fn=_sum2, kind="reduce", init=0.0)
    return Program(
        rules=[k_sq, k_sum],
        axioms=[axiom("u[k?][j?][i?]", k="Nk", j="Nj", i="Ni")],
        goals=[goal("energy(u)", store_as="energy")],
        loop_order=("k", "j", "i"),
        name=name,
    )


def plane_sum_program(name: str = "plane_sum") -> Program:
    """Per-plane sums ``colsum[k] = sum_{j,i} u[k][j][i]^2``.

    The reduction output keeps the outer dim: the executor re-initializes
    the accumulator row at the first row of each k-tile and emits one
    combined row per tile."""
    k_sq = kernel("sq", [("a", "u?[k?][j?][i?]")],
                  [("o", "sq(u?[k?][j?][i?])")], fn=_sq1)
    k_sum = kernel("plane_sum", [("x", "sq(u[k?][j][i])")],
                   [("acc", "colsum(u[k?])")], fn=_sum2, kind="reduce",
                   init=0.0)
    return Program(
        rules=[k_sq, k_sum],
        axioms=[axiom("u[k?][j?][i?]", k="Nk", j="Nj", i="Ni")],
        goals=[goal("colsum(u[k])", store_as="colsum", k=("Nk", 0, 0))],
        loop_order=("k", "j", "i"),
        name=name,
    )


def _heat7(km, kp, n, s, w_, e, c):
    return c + 0.1 * (km + kp + n + s + w_ + e - 6.0 * c)


def heat3d_program(name: str = "heat3d") -> Program:
    """The 7-point 3-D heat stencil over ``(k, j, i)``.

    The ``u[k-1]``/``u[k+1]`` reads are stencil offsets in an *outer*
    loop dim: on the stencil executor the input gets a 3-plane VMEM
    window rotated across the k grid dim (planes stay resident instead
    of being re-streamed), with one warm-up tile priming the window and
    the k-halo'd goal extent trimmed on the host."""
    k_heat = kernel(
        "heat7",
        inputs=[
            ("km", "u?[k?-1][j?][i?]"),
            ("kp", "u?[k?+1][j?][i?]"),
            ("n", "u?[k?][j?-1][i?]"),
            ("s", "u?[k?][j?+1][i?]"),
            ("w", "u?[k?][j?][i?-1]"),
            ("e", "u?[k?][j?][i?+1]"),
            ("c", "u?[k?][j?][i?]"),
        ],
        outputs=[("o", "heat(u?[k?][j?][i?])")],
        fn=_heat7,
    )
    return Program(
        rules=[k_heat],
        axioms=[axiom("u[k?][j?][i?]", k="Nk", j="Nj", i="Ni")],
        goals=[goal("heat(u[k][j][i])", store_as="heat",
                    k=("Nk", 1, -1), j=("Nj", 1, -1), i=("Ni", 1, -1))],
        loop_order=("k", "j", "i"),
        name=name,
    )


def _stage2(a, b):
    return 0.5 * (a + b)


def heat3d_stage_program(name: str = "heat3d_stage") -> Program:
    """A two-stage 3-D heat pipeline: pre-smooth, then the 7-point
    stencil over the *pre-smoothed* field.

    The ``st(u[k-1])``/``st(u[k+1])`` reads put a plane-dim stencil
    offset on a variable *produced in the same nest*: the stage kernel
    runs one tile ahead of the outer grid (its plane-dim software-
    pipeline lead) and writes a **producer plane window** — 3 whole
    planes resident in VMEM, rotated across k tiles — from which the
    heat kernel reads without any HBM round-trip.  The intermediate is
    consumed only in-nest, so it is never materialized at all."""
    k_stage = kernel(
        "stage",
        inputs=[("a", "u?[k?][j?][i?]"), ("b", "u?[k?][j?][i?+1]")],
        outputs=[("o", "st(u?[k?][j?][i?])")],
        fn=_stage2,
    )
    k_heat = kernel(
        "heat7",
        inputs=[
            ("km", "st(u?[k?-1][j?][i?])"),
            ("kp", "st(u?[k?+1][j?][i?])"),
            ("n", "st(u?[k?][j?-1][i?])"),
            ("s", "st(u?[k?][j?+1][i?])"),
            ("w", "st(u?[k?][j?][i?-1])"),
            ("e", "st(u?[k?][j?][i?+1])"),
            ("c", "st(u?[k?][j?][i?])"),
        ],
        outputs=[("o", "heat(u?[k?][j?][i?])")],
        fn=_heat7,
    )
    return Program(
        rules=[k_stage, k_heat],
        axioms=[axiom("u[k?][j?][i?]", k="Nk", j="Nj", i="Ni")],
        goals=[goal("heat(u[k][j][i])", store_as="heat",
                    k=("Nk", 1, -1), j=("Nj", 1, -1), i=("Ni", 1, -2))],
        loop_order=("k", "j", "i"),
        name=name,
    )


def _resid2(h, c):
    d = h - c
    return d * d


def heat3d_residual_norm_program(name: str = "heat3d_residual_norm") -> Program:
    """The 7-point heat stencil *and* its squared-residual norm in one
    fused nest — a halo'd reduction.

    ``u`` streams through a 3-plane VMEM window (k +/- 1 halo reads)
    while the residual reduction's carried accumulator rides the same
    grid, its combines predicated off the window's warm-up tiles; the
    heat field is both a terminal output and a same-step operand of the
    residual kernel."""
    k_heat = kernel(
        "heat7",
        inputs=[
            ("km", "u?[k?-1][j?][i?]"),
            ("kp", "u?[k?+1][j?][i?]"),
            ("n", "u?[k?][j?-1][i?]"),
            ("s", "u?[k?][j?+1][i?]"),
            ("w", "u?[k?][j?][i?-1]"),
            ("e", "u?[k?][j?][i?+1]"),
            ("c", "u?[k?][j?][i?]"),
        ],
        outputs=[("o", "heat(u?[k?][j?][i?])")],
        fn=_heat7,
    )
    k_res = kernel(
        "resid",
        inputs=[("h", "heat(u?[k?][j?][i?])"), ("c", "u?[k?][j?][i?]")],
        outputs=[("r", "resid(u?[k?][j?][i?])")],
        fn=_resid2,
    )
    k_sum = kernel(
        "res_sum",
        inputs=[("x", "resid(u[k][j][i])")],
        outputs=[("acc", "rnorm(u)")],
        fn=_sum2,
        kind="reduce",
        init=0.0,
    )
    return Program(
        rules=[k_heat, k_res, k_sum],
        axioms=[axiom("u[k?][j?][i?]", k="Nk", j="Nj", i="Ni")],
        goals=[
            goal("heat(u[k][j][i])", store_as="heat",
                 k=("Nk", 1, -1), j=("Nj", 1, -1), i=("Ni", 1, -1)),
            goal("rnorm(u)", store_as="rnorm"),
        ],
        loop_order=("k", "j", "i"),
        name=name,
    )


def _advect4(km, kp, c, w_):
    return c - 0.25 * (kp - km) + 0.05 * (c - w_)


def advect4d_halo_program(name: str = "advect4d_halo") -> Program:
    """k-upwind advection over a 4-D ``(l, k, j, i)`` space.

    The ``u[l][k-1]``/``u[l][k+1]`` reads exercise a plane window on a
    grid with *two* outer dims: ``l`` flattens onto the leading grid dim
    unchanged while ``k`` (the plane dim) carries the 3-plane window and
    its warm-up tiles."""
    k_adv = kernel(
        "advect",
        inputs=[
            ("km", "u?[l?][k?-1][j?][i?]"),
            ("kp", "u?[l?][k?+1][j?][i?]"),
            ("c", "u?[l?][k?][j?][i?]"),
            ("w", "u?[l?][k?][j?][i?-1]"),
        ],
        outputs=[("o", "adv(u?[l?][k?][j?][i?])")],
        fn=_advect4,
    )
    return Program(
        rules=[k_adv],
        axioms=[axiom("u[l?][k?][j?][i?]", l="Nl", k="Nk", j="Nj", i="Ni")],
        goals=[goal("adv(u[l][k][j][i])", store_as="adv",
                    l=("Nl", 0, 0), k=("Nk", 1, -1),
                    j=("Nj", 0, 0), i=("Ni", 1, 0))],
        loop_order=("l", "k", "j", "i"),
        name=name,
    )


def row_sum_program(name: str = "row_sum") -> Program:
    """Row sums of squares ``rsum[j] = sum_i u[j][i]^2``.

    The reduction output keeps the *row* dim: each grid step's combine
    is final for its row, so the executor emits one identity-padded
    partial-accumulator row per step and lane-reduces on the host; the
    JAX backend keeps a per-row cell in the accumulator array."""
    k_sq = kernel("sq", [("a", "u?[j?][i?]")],
                  [("o", "sq(u?[j?][i?])")], fn=_sq1)
    k_sum = kernel("row_sum", [("x", "sq(u[j?][i])")],
                   [("acc", "rsum(u[j?])")], fn=_sum2, kind="reduce",
                   init=0.0)
    return Program(
        rules=[k_sq, k_sum],
        axioms=[axiom("u[j?][i?]", j="Nj", i="Ni")],
        goals=[goal("rsum(u[j])", store_as="rsum", j=("Nj", 0, 0))],
        loop_order=("j", "i"),
        name=name,
    )


def subset_sum_program(name: str = "subset_sum") -> Program:
    """Per-level sums ``lsum[l] = sum_{k,j,i} u[l][k][j][i]^2``.

    The reduction output keeps a *strict leading subset* of the outer
    dims (``l`` of ``(l, k)``): the executor re-initializes the VMEM
    accumulator row at the first step of every l tile and emits one
    combined row per tile."""
    k_sq = kernel("sq", [("a", "u?[l?][k?][j?][i?]")],
                  [("o", "sq(u?[l?][k?][j?][i?])")], fn=_sq1)
    k_sum = kernel("subset_sum", [("x", "sq(u[l?][k][j][i])")],
                   [("acc", "lsum(u[l?])")], fn=_sum2, kind="reduce",
                   init=0.0)
    return Program(
        rules=[k_sq, k_sum],
        axioms=[axiom("u[l?][k?][j?][i?]", l="Nl", k="Nk", j="Nj", i="Ni")],
        goals=[goal("lsum(u[l])", store_as="lsum", l=("Nl", 0, 0))],
        loop_order=("l", "k", "j", "i"),
        name=name,
    )


def _rough(f0, fm):
    d = f0 - fm
    return d * d


def smooth_norm_program(name: str = "smooth_norm") -> Program:
    """Normalize a flux by the L2 norm of its vertical *roughness*.

    Like :func:`normalization_program`, fuses to two nests around the
    reduction->broadcast split — but the roughness kernel reads the flux
    at rows ``j`` and ``j-1`` inside the producing nest while the flux
    also crosses the split to the normalize nest: a cross-row read of a
    same-nest materialized variable, served from a rolling VMEM window
    on the stencil executor."""
    rules = [
        kernel(
            "flux",
            inputs=[("a", "u?[j?][i?]"), ("b", "u?[j?][i?+1]")],
            outputs=[("f", "flux(u?[j?][i?])")],
            fn=_flux,
        ),
        kernel(
            "rough",
            inputs=[("f0", "flux(u?[j?][i?])"), ("fm", "flux(u?[j?-1][i?])")],
            outputs=[("r", "rough(u?[j?][i?])")],
            fn=_rough,
        ),
        kernel(
            "rough_accum",
            inputs=[("x", "rough(u[j][i])")],
            outputs=[("acc", "nrm2(u)")],
            fn=_accum,
            kind="reduce",
            init=0.0,
        ),
        kernel(
            "norm_root",
            inputs=[("n2", "nrm2(u?)")],
            outputs=[("r", "invnorm(u?)")],
            fn=_rsqrt_n,
        ),
        kernel(
            "normalize",
            inputs=[("f", "flux(u?[j?][i?])"), ("inv", "invnorm(u?)")],
            outputs=[("o", "nflux(u?[j?][i?])")],
            fn=_scale,
        ),
    ]
    return Program(
        rules=rules,
        axioms=[axiom("u[j?][i?]", j="Nj", i="Ni")],
        goals=[goal("nflux(u[j][i])", store_as="nflux",
                    j=("Nj", 0, 0), i=("Ni", 0, -1))],
        loop_order=("j", "i"),
        name=name,
    )


# ---------------------------------------------------------------------------
# Normalization example (Figs. 3/4/6, Section 5.2)
# ---------------------------------------------------------------------------

def _flux(a, b):
    return b - a


def _square(f):
    return f * f


def _accum(acc, x):
    return acc + x


def _rsqrt_n(nrm2):
    return 1.0 / sqrt(nrm2 + 1e-30)


def _scale(f, inv):
    return f * inv


def normalization_program(name: str = "normalization") -> Program:
    rules = [
        kernel(
            "flux",
            inputs=[("a", "u?[j?][i?]"), ("b", "u?[j?][i?+1]")],
            outputs=[("f", "flux(u?[j?][i?])")],
            fn=_flux,
        ),
        kernel(
            "fluxsq",
            inputs=[("f", "flux(u?[j?][i?])")],
            outputs=[("s", "fluxsq(u?[j?][i?])")],
            fn=_square,
        ),
        kernel(
            "norm_accum",
            inputs=[("x", "fluxsq(u[j][i])")],
            outputs=[("acc", "nrm2(u)")],
            fn=_accum,
            kind="reduce",
            init=0.0,
        ),
        kernel(
            "norm_root",
            inputs=[("n2", "nrm2(u?)")],
            outputs=[("r", "invnorm(u?)")],
            fn=_rsqrt_n,
        ),
        kernel(
            "normalize",
            inputs=[("f", "flux(u?[j?][i?])"), ("inv", "invnorm(u?)")],
            outputs=[("o", "nflux(u?[j?][i?])")],
            fn=_scale,
        ),
    ]
    return Program(
        rules=rules,
        axioms=[axiom("u[j?][i?]", j="Nj", i="Ni")],
        goals=[goal("nflux(u[j][i])", store_as="nflux",
                    j=("Nj", 0, 0), i=("Ni", 0, -1))],
        loop_order=("j", "i"),
        name=name,
    )


# ---------------------------------------------------------------------------
# COSMO fourth-order diffusion micro-kernels (Section 5.3)
# ---------------------------------------------------------------------------

def _ulap(n, e, s, w_, c):
    return n + e + s + w_ - 4.0 * c


def _flux_x(u0, u1, l0, l1):
    fl = l1 - l0
    return where(fl * (u1 - u0) > 0.0, 0.0, fl)


def _flux_y(u0, u1, l0, l1):
    fl = l1 - l0
    return where(fl * (u1 - u0) > 0.0, 0.0, fl)


def _ustage(c, fxm, fx, fym, fy):
    return c - 0.1 * ((fx - fxm) + (fy - fym))


def cosmo_program(name: str = "cosmo") -> Program:
    rules = [
        kernel(
            "ulapstage",
            inputs=[
                ("n", "u?[k?][j?-1][i?]"),
                ("e", "u?[k?][j?][i?+1]"),
                ("s", "u?[k?][j?+1][i?]"),
                ("w", "u?[k?][j?][i?-1]"),
                ("c", "u?[k?][j?][i?]"),
            ],
            outputs=[("o", "ulap(u?[k?][j?][i?])")],
            fn=_ulap,
        ),
        kernel(
            "flux_x",
            inputs=[
                ("u0", "u?[k?][j?][i?]"),
                ("u1", "u?[k?][j?][i?+1]"),
                ("l0", "ulap(u?[k?][j?][i?])"),
                ("l1", "ulap(u?[k?][j?][i?+1])"),
            ],
            outputs=[("fx", "fx(u?[k?][j?][i?])")],
            fn=_flux_x,
        ),
        kernel(
            "flux_y",
            inputs=[
                ("u0", "u?[k?][j?][i?]"),
                ("u1", "u?[k?][j?+1][i?]"),
                ("l0", "ulap(u?[k?][j?][i?])"),
                ("l1", "ulap(u?[k?][j?+1][i?])"),
            ],
            outputs=[("fy", "fy(u?[k?][j?][i?])")],
            fn=_flux_y,
        ),
        kernel(
            "ustage",
            inputs=[
                ("c", "u?[k?][j?][i?]"),
                ("fxm", "fx(u?[k?][j?][i?-1])"),
                ("fx", "fx(u?[k?][j?][i?])"),
                ("fym", "fy(u?[k?][j?-1][i?])"),
                ("fy", "fy(u?[k?][j?][i?])"),
            ],
            outputs=[("o", "unew(u?[k?][j?][i?])")],
            fn=_ustage,
        ),
    ]
    return Program(
        rules=rules,
        axioms=[axiom("u[k?][j?][i?]", k="Nk", j="Nj", i="Ni")],
        goals=[goal("unew(u[k][j][i])", store_as="unew",
                    k=("Nk", 0, 0), j=("Nj", 2, -2), i=("Ni", 2, -2))],
        loop_order=("k", "j", "i"),
        name=name,
    )


# ---------------------------------------------------------------------------
# Hydro-style dimensionally-split pass (Section 5.4, simplified)
# ---------------------------------------------------------------------------

def _constoprim(rho, mom):
    v = mom / rho
    return v


def _eos(rho, v):
    p = 0.4 * rho * (1.0 + 0.5 * v * v)
    return p


def _slope(qm, q0, qp):
    dl = q0 - qm
    dr = qp - q0
    s = where(dl * dr > 0.0, 2.0 * dl * dr / (dl + dr + 1e-30), 0.0)
    return s


def _trace(q0, s):
    ql = q0 - 0.5 * s
    qr = q0 + 0.5 * s
    return ql, qr


def _riemann(qrL, qlR, pL, pR):
    # toy HLL-style interface state between cell i (right face) and i+1
    return where(pL > pR, qrL, qlR)

def _cmpflx(qs, ps):
    return qs * ps


def _update(q0, fm, f0):
    return q0 - 0.05 * (f0 - fm)


def hydro1d_program(name: str = "hydro1d") -> Program:
    rules = [
        kernel(
            "constoprim",
            # 'mom' is concrete: an input name that does not appear in the
            # output pattern cannot be bound by backward chaining.
            inputs=[("rho", "rho?[j?][i?]"), ("mom", "mom[j?][i?]")],
            outputs=[("v", "vel(rho?[j?][i?])")],
            fn=_constoprim,
        ),
        kernel(
            "eos",
            inputs=[("rho", "rho?[j?][i?]"), ("v", "vel(rho?[j?][i?])")],
            outputs=[("p", "pres(rho?[j?][i?])")],
            fn=_eos,
        ),
        kernel(
            "slope",
            inputs=[
                ("qm", "vel(rho?[j?][i?-1])"),
                ("q0", "vel(rho?[j?][i?])"),
                ("qp", "vel(rho?[j?][i?+1])"),
            ],
            outputs=[("s", "slope(rho?[j?][i?])")],
            fn=_slope,
        ),
        kernel(
            "trace",
            inputs=[("q0", "vel(rho?[j?][i?])"), ("s", "slope(rho?[j?][i?])")],
            outputs=[("ql", "traceL(rho?[j?][i?])"), ("qr", "traceR(rho?[j?][i?])")],
            fn=_trace,
        ),
        kernel(
            "riemann",
            inputs=[
                ("qrL", "traceR(rho?[j?][i?])"),
                ("qlR", "traceL(rho?[j?][i?+1])"),
                ("pL", "pres(rho?[j?][i?])"),
                ("pR", "pres(rho?[j?][i?+1])"),
            ],
            outputs=[("qs", "qstar(rho?[j?][i?])")],
            fn=_riemann,
        ),
        kernel(
            "cmpflx",
            inputs=[("qs", "qstar(rho?[j?][i?])"), ("ps", "pres(rho?[j?][i?])")],
            outputs=[("f", "flx(rho?[j?][i?])")],
            fn=_cmpflx,
        ),
        kernel(
            "update",
            inputs=[
                ("q0", "rho?[j?][i?]"),
                ("fm", "flx(rho?[j?][i?-1])"),
                ("f0", "flx(rho?[j?][i?])"),
            ],
            outputs=[("o", "rnew(rho?[j?][i?])")],
            fn=_update,
        ),
    ]
    return Program(
        rules=rules,
        axioms=[
            axiom("rho[j?][i?]", j="Nj", i="Ni"),
            axiom("mom[j?][i?]", j="Nj", i="Ni"),
        ],
        goals=[goal("rnew(rho[j][i])", store_as="rnew",
                    j=("Nj", 0, 0), i=("Ni", 2, -2))],
        loop_order=("j", "i"),
        name=name,
    )


# ---------------------------------------------------------------------------
# Program registry
# ---------------------------------------------------------------------------

#: Every program in this module, by default name.  One golden plan per
#: entry lives under tests/goldens/plans/ (regenerate with
#: ``scripts/warm_cache.py --goldens``); ``scripts/warm_cache.py`` also
#: pre-plans each entry into an on-disk AOT cache.
ALL_PROGRAMS = {
    "laplace5": laplace5_program,
    "laplace_pair": laplace_pair_program,
    "pyramid4d": pyramid4d_program,
    "energy3d": energy3d_program,
    "plane_sum": plane_sum_program,
    "heat3d": heat3d_program,
    "heat3d_stage": heat3d_stage_program,
    "heat3d_residual_norm": heat3d_residual_norm_program,
    "advect4d_halo": advect4d_halo_program,
    "row_sum": row_sum_program,
    "subset_sum": subset_sum_program,
    "smooth_norm": smooth_norm_program,
    "normalization": normalization_program,
    "cosmo": cosmo_program,
    "hydro1d": hydro1d_program,
    "hydro2d": hydro2d_program,
    "courant": courant_program,
    "hydroc": hydroc_program,
}

#: The programs of :data:`ALL_PROGRAMS` the reference package lacks:
#: their golden plans live under tests/goldens/port_plans/.
PORT_ONLY = ("hydro2d", "courant", "hydroc")
