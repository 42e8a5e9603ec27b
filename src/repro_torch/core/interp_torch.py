"""Plain PyTorch plan interpreter: the KernelPlan semantics in eager torch.

The port's counterpart of ``repro.core.interp_jax`` and the plain
version of the CUDA stencil kernel
(:mod:`repro_torch.kernels.stencil2d.kernel`): it executes the *same
validated KernelPlan*, transliterated step for step from the JAX
package's ``interp_jax.build_call``.  The ``lax.fori_loop`` over the
linearized grid becomes a Python loop; the linear index is decomposed
by the same odometer (last dimension fastest — the fused nest's
traversal order), and the loop-carried state becomes tensors updated in
place: rolling row windows ``(stages, width)``, streamed and producer
plane windows ``(p_stages, rows, width)``, accumulator rows, and the
padded outputs themselves.  Every mechanism keeps the reference
semantics — clamped row/plane streaming (edge rows repeat during
warm-up/drain), floor-mod slot rotation, predicated accumulator
combines over rows *and* outer tiles, predicated absolute-row seating
of producer planes, identity-filled output rows — so the output
contract matches the reference ``build_call`` in shape and the shared
host half (:func:`repro_torch.core.interpreters.execute_plan`)
assembles it with the identical trim/seat rules.

Positions are plain Python integers here, so the predicates of the
reference become ``if`` statements.  It runs on the CPU in the tests
and on the card in ``chip_smoke.py``, where the CUDA kernel is held
against it; nothing on the ``"cuda"`` path calls it.

Like ``interp_jax`` it is **layout-aware**
(``InterpreterSpec.layout_aware=True``): it executes the constructs the
LayoutApply pass (:mod:`repro_torch.core.layoutapply`) writes —
carried-vector slots (``CallPlan.vloads``: each ``vec:`` register slot
is one clamped widened load per *distinct* slot the steps read, and an
input window every access of which was absorbed is neither carried nor
streamed), physically left-padded windows (``align_pad``: the streamed
row seats at the pad column and every access shifts with it), and
device-side lane pre-folds for row-kept reductions
(``OutputPlan.lane_block``).  The CUDA kernel is not: like the
reference's Pallas kernel it refuses those constructs.
"""
from __future__ import annotations

import torch

from .interpreters import (InterpreterSpec, register_interpreter,
                           require_hazard_free, require_linked_fns)
from .plan import PLAN_FEATURES, CallPlan, WindowPlan
from .runtime import lane_reduce


def _clip(v: int, lo: int, hi: int) -> int:
    return max(lo, min(v, hi))


def build_call(call: CallPlan, sizes: tuple[int, ...], dtype, *,
               device=None):
    """Concretize one :class:`CallPlan` as an eager-torch callable.

    Mirrors the reference ``build_call`` contract: ``sizes`` is
    ``(*outer_sizes, Nj, Ni)``, the result is ``(fn, steps_j)``, and
    ``fn`` maps the call's input tensors (scalars as ``(1, 1)``) to one
    padded output per ``call.outputs`` entry (a list when several),
    allocated on the inputs' device."""
    n_out = call.n_outer
    if len(sizes) != n_out + 2:
        raise ValueError(
            f"call {call.name} has n_outer={n_out} but got sizes {sizes}"
        )
    require_linked_fns(call)
    require_hazard_free(call)
    *outer_sizes, nj, ni = sizes
    o_lo = call.outer_lo
    o_hi = call.outer_hi_off
    gsz = [outer_sizes[d] + o_hi[d] - o_lo[d] for d in range(n_out)]
    steps_j = (nj + call.x_hi_off) - call.x_lo
    total_steps = steps_j
    for s in gsz:
        total_steps *= s

    arr_ins = [i for i in call.inputs if not i.scalar]
    row_ins = [i for i in arr_ins if not i.plane]
    plane_ins = [i for i in arr_ins if i.plane]
    roll_wins = [WindowPlan(f"in_{i.name}", i.stages, i.i_lo, i.i_hi,
                            align_pad=i.align_pad)
                 for i in row_ins] + [w for w in call.windows if not w.plane]
    plane_wins = [w for w in call.windows if w.plane]
    bwidth = {w.name: ni + (w.i_hi - w.i_lo) + w.align_pad
              for w in roll_wins + plane_wins}
    win_h = {w.name: nj + (w.j_hi - w.j_lo) for w in plane_wins}
    acc_w = {a.name: ni + a.w_off for a in call.accs}
    ref_idx = {ispec.name: k for k, ispec in enumerate(call.inputs)}
    ispec_of = {i.name: i for i in arr_ins}
    in_h = {i.name: nj + (i.j_hi - i.j_lo) for i in arr_ins}
    in_w = {i.name: ni + (i.i_hi - i.i_lo) for i in arr_ins}
    roll_of = {w.name: w for w in roll_wins}
    acc_of = {a.name: a for a in call.accs}
    pwin_of = {w.name: w for w in plane_wins}
    vload_of = {v.name: v for v in call.vloads}

    # Carried-vector realization, as in the reference interp_jax: each
    # ``vec:`` register slot k holds the widened load from the source row
    # k grid steps behind the newest, re-sliced from the source directly
    # (clamped, exactly as streaming would have fetched it), one load per
    # *distinct* slot the steps read.  Values differ from a literal
    # register file only during warm-up, whose rows never survive output
    # assembly.
    vec_slots = {v.name: sorted({v.j_off - rd.j_off
                                 for s in call.steps for rd in s.reads
                                 if rd.src == f"vec:{v.name}"})
                 for v in call.vloads}
    direct_srcs = {rd.src for s in call.steps for rd in s.reads}
    # an input window every access of which was absorbed by vec registers
    # carries no readable state: drop it, and its streaming, entirely
    dead_srcs = {f"in_{i.name}" for i in arr_ins
                 if f"in_{i.name}" not in direct_srcs
                 and any(v.src == f"in_{i.name}" for v in call.vloads)}
    roll_wins = [w for w in roll_wins if w.name not in dead_srcs]
    roll_of = {w.name: w for w in roll_wins}
    live_plane_ins = [i for i in plane_ins
                      if f"in_{i.name}" not in dead_srcs]

    def _row_pos(ispec, x):
        """Source row index of ``ispec`` for canonical position ``x``
        (clamped: edge rows repeat during warm-up/drain)."""
        return _clip(x + ispec.lead - ispec.j_lo, 0, in_h[ispec.name] - 1)

    def _outer_src(ispec, pos, p_off=None):
        """Source indices for the input's own outer dims at canonical
        outer positions ``pos`` (the plane dim runs ``p_lead`` ahead, or
        ``p_off`` for a vec-register load; all clamped so warm-up/drain
        tiles fetch edge planes)."""
        a_out = ispec.n_outer
        ilos = ispec.outer_los or (0,) * a_out
        ihis = ispec.outer_his or (0,) * a_out
        idxs = []
        for li, d in enumerate(range(n_out - a_out, n_out)):
            n_planes = outer_sizes[d] + ihis[li] - ilos[li]
            p = pos[d]
            if ispec.plane and d == n_out - 1:
                p = p + (ispec.p_lead if p_off is None else p_off)
            idxs.append(_clip(p - ilos[li], 0, n_planes - 1))
        return tuple(idxs)

    def fn(*args):
        dev = args[0].device if args else device
        st = {}
        for w in roll_wins:
            st[("win", w.name)] = torch.zeros((w.stages, bwidth[w.name]),
                                              dtype=dtype, device=dev)
        for i in live_plane_ins:
            st[("plane", i.name)] = torch.zeros(
                (i.p_stages, in_h[i.name], in_w[i.name] + i.align_pad),
                dtype=dtype, device=dev)
        for w in plane_wins:
            st[("pwin", w.name)] = torch.zeros(
                (w.p_stages, win_h[w.name], bwidth[w.name]), dtype=dtype,
                device=dev)
        for a in call.accs:
            st[("acc", a.name)] = torch.full((acc_w[a.name],), a.init,
                                             dtype=dtype, device=dev)
        outs = []
        for out in call.outputs:
            if out.acc is not None:
                a = acc_of[out.acc]
                wa = acc_w[out.acc]
                shape = (*gsz[:a.n_kept], wa) if a.n_kept else (1, wa)
            else:
                shape = (*gsz, steps_j, out.lane_block or ni)
            outs.append(torch.zeros(shape, dtype=dtype, device=dev))

        for lin in range(total_steps):
            jid = lin % steps_j
            rest = lin // steps_j
            outer_ids = [0] * n_out
            for d in reversed(range(n_out)):
                outer_ids[d] = rest % gsz[d]
                rest = rest // gsz[d]
            opos = [outer_ids[d] + o_lo[d] for d in range(n_out)]
            x = jid + call.x_lo

            # 0. identity-initialize accumulators (carried: first grid
            # step; kept-prefix: first step of every kept tile)
            for a in call.accs:
                if jid == 0 and all(outer_ids[d] == 0
                                    for d in range(a.n_kept, n_out)):
                    st[("acc", a.name)].fill_(a.init)

            # 1. stream one new row per array input into its window
            # (inputs whose window was dropped as dead are not streamed:
            # their rows reach the steps as vec registers)
            for ispec in arr_ins:
                if f"in_{ispec.name}" in dead_srcs:
                    continue
                src = args[ref_idx[ispec.name]]
                row = src[_outer_src(ispec, opos) + (_row_pos(ispec, x),)]
                pad = ispec.align_pad
                if ispec.plane:
                    slot = (opos[n_out - 1] + ispec.p_lead) % ispec.p_stages
                    st[("plane", ispec.name)][
                        slot, _row_pos(ispec, x), pad:pad + row.shape[0]] = row
                else:
                    slot = (x + ispec.lead) % ispec.stages
                    st[("win", f"in_{ispec.name}")][
                        slot, pad:pad + row.shape[0]] = row

            # 1b. realize carried vectors: the slots' rows are contiguous
            # in the source, so every register fills from one clamped
            # block load (a grid shorter than the register file clamps
            # each slot's row on its own)
            vec_vals = {}
            for v in call.vloads:
                slots = vec_slots[v.name]
                if not slots:
                    continue
                ispec = ispec_of[v.src[3:]]
                src = args[ref_idx[ispec.name]]
                outer = _outer_src(ispec, opos, v.p_off)
                wv = ni + v.w_off
                c0 = _clip(v.col0 - ispec.i_lo, 0, in_w[ispec.name] - wv)
                m1 = slots[-1]
                h = m1 - slots[0] + 1
                if h <= in_h[ispec.name]:
                    r0 = _clip(x - m1 + v.j_off - ispec.j_lo, 0,
                               in_h[ispec.name] - h)
                    block = src[outer + (slice(r0, r0 + h),
                                         slice(c0, c0 + wv))]
                    for k in slots:
                        vec_vals[(v.name, k)] = block[m1 - k]
                else:
                    for k in slots:
                        r_idx = _clip(x - k + v.j_off - ispec.j_lo, 0,
                                      in_h[ispec.name] - 1)
                        vec_vals[(v.name, k)] = src[outer + (r_idx,)][
                            c0:c0 + wv]

            # 2. fused steps, in dataflow order, at their leads
            local: dict[str, torch.Tensor] = {}
            for step in call.steps:
                ins = []
                cur = None
                if step.acc is not None:
                    cur = st[("acc", step.acc)]
                    ins.append(cur)
                for rd in step.reads:
                    w = ni + rd.w_off
                    if rd.src.startswith("local:"):
                        ins.append(local[rd.src[6:]][rd.col0:rd.col0 + w])
                    elif rd.src.startswith("scalar:"):
                        ins.append(args[ref_idx[rd.src[7:]]][0, 0])
                    elif rd.src.startswith("vec:"):
                        # carried-vector register read: static slot (how
                        # many steps ago the value was loaded) and static
                        # column re-basing inside the wide load
                        v = vload_of[rd.src[4:]]
                        c0 = rd.col0 - v.col0
                        ins.append(vec_vals[(v.name, v.j_off - rd.j_off)]
                                   [c0:c0 + w])
                    elif rd.src.startswith("in_") and \
                            ispec_of.get(rd.src[3:]) is not None and \
                            ispec_of[rd.src[3:]].plane:
                        # streamed plane-window read: mod-stage plane
                        # slot, absolute row inside it
                        ispec = ispec_of[rd.src[3:]]
                        slot = (opos[n_out - 1] + rd.p_off) % ispec.p_stages
                        r_idx = _clip(x + rd.j_off - ispec.j_lo, 0,
                                      in_h[ispec.name] - 1)
                        c0 = rd.col0 - ispec.i_lo + ispec.align_pad
                        ins.append(st[("plane", ispec.name)]
                                   [slot, r_idx, c0:c0 + w])
                    elif rd.src in pwin_of:
                        # producer plane-window read: older planes
                        # resident, rows addressed absolutely
                        pw = pwin_of[rd.src]
                        slot = (opos[n_out - 1] + rd.p_off) % pw.p_stages
                        r_idx = _clip(x + rd.j_off - pw.j_lo, 0,
                                      win_h[pw.name] - 1)
                        c0 = rd.col0 - pw.i_lo + pw.align_pad
                        ins.append(st[("pwin", pw.name)]
                                   [slot, r_idx, c0:c0 + w])
                    else:
                        b = roll_of[rd.src]
                        c0 = rd.col0 - b.i_lo + b.align_pad
                        ins.append(st[("win", b.name)]
                                   [(x + rd.j_off) % b.stages, c0:c0 + w])
                vals = call.fns[step.fn_idx](*ins)
                if step.acc is not None:
                    # predicated combine: warm-up/drain rows and tiles
                    # must not pollute
                    lo, hi = step.valid
                    pos = x + step.lead
                    ok = lo <= pos < nj + hi
                    for d, (vlo, vhi) in enumerate(step.valid_outer):
                        ok = ok and vlo <= opos[d] < outer_sizes[d] + vhi
                    if ok:
                        st[("acc", step.acc)] = vals
                    continue
                if len(step.writes) == 1:
                    vals = (vals,)
                for targets, val in zip(step.writes, vals):
                    for wkind, wtgt in targets:
                        if wkind == "local":
                            local[str(wtgt)] = val
                        elif wkind == "buf" and str(wtgt) in pwin_of:
                            # producer plane window: newest slot,
                            # absolute row seating, predicated to the
                            # plane's row extent
                            pw = pwin_of[str(wtgt)]
                            slot = (opos[n_out - 1] + pw.p_lead) % pw.p_stages
                            r_idx = x + step.lead - pw.j_lo
                            if 0 <= r_idx < win_h[pw.name]:
                                c0 = step.out_col0 - pw.i_lo + pw.align_pad
                                st[("pwin", pw.name)][
                                    slot, r_idx, c0:c0 + val.shape[0]] = val
                        elif wkind == "buf":
                            b = roll_of[str(wtgt)]
                            c0 = step.out_col0 - b.i_lo + b.align_pad
                            st[("win", b.name)][
                                (x + step.lead) % b.stages,
                                c0:c0 + val.shape[0]] = val
                        else:  # 3. one output row for this grid step
                            oi = int(wtgt)
                            ospec = call.outputs[oi]
                            orow = outs[oi][tuple(outer_ids) + (jid,)]
                            if ospec.lane_block:
                                # device pre-fold: identity-pad the row to
                                # whole lane blocks and fold them down to
                                # one (the host lane-reduces the rest)
                                lb = ospec.lane_block
                                chunks = -(-ni // lb)
                                pad = torch.full((chunks * lb,), ospec.fill,
                                                 dtype=dtype, device=dev)
                                pad[step.out_col0:step.out_col0
                                    + val.shape[0]] = val
                                orow.copy_(lane_reduce(
                                    call.fns[ospec.reduce_idx],
                                    pad.reshape(chunks, lb),
                                    ospec.reduce_init))
                                continue
                            orow.fill_(ospec.fill)
                            orow[step.out_col0:step.out_col0
                                 + val.shape[0]] = val

            # 3b. dump accumulators into their revisited output blocks
            for oi, out in enumerate(call.outputs):
                if out.acc is not None:
                    a = acc_of[out.acc]
                    row = st[("acc", out.acc)]
                    if a.n_kept:
                        outs[oi][tuple(outer_ids[:a.n_kept])] = row
                    else:
                        outs[oi][0] = row
        return outs if len(outs) > 1 else outs[0]

    return fn, steps_j


register_interpreter(InterpreterSpec(
    name="interp_torch",
    build_call=build_call,
    # unit-stride lane slicing only, like the CUDA kernel: a plan with
    # non-unit ReadPlan.i_stride must refuse, not miscompile
    capabilities=PLAN_FEATURES - frozenset({"strided_reads"}),
    dtypes=frozenset({torch.float32, torch.float64, torch.bfloat16}),
    flags=frozenset(),
    description="plain PyTorch plan interpreter (Python loop over the "
                "linearized grid; tensors as the carried windows and "
                "accumulators); the CUDA kernel's plain version; "
                "executes LayoutApply's carried-vector / align_pad / "
                "lane_block constructs",
    layout_aware=True,
))
