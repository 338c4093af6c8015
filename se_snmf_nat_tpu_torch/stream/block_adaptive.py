"""Block-adaptive execution plan over a batch of lanes (port of
``se_snmf_nat_tpu.stream.block_adaptive``).

Within a block of K frames the noise dictionary is frozen, so the K
activation solves of a lane run as one H-solve (kernel ``mu_h_solve_lanes``);
a per-frame gain scan (kernel ``gain_scan_lanes``) computes triggers and
the enhanced spectra; the triggered frames are pushed into two m_a-deep
rings; and at the block boundary one W-only refit (kernel
``mu_w_solve_lanes``) runs on every lane in which a frame scheduled it.
The dictionary lags by up to K frames: a documented deviation from the
reference's per-frame online learning.  On the card the step runs as one
CUDA graph a block, as the reference's block runs as one XLA program.

The lane (batch) dimension is written out where the reference used
``vmap``; its ``lax.cond`` around the refit is the kernel's per-lane
``active`` flag and a per-lane select.  The rings are written with a
circular pointer per lane (index writes) and rolled back to chronological
order for the refit and at the end of a run, which gives the values of the
reference's shift rings exactly.
"""

from __future__ import annotations

import torch
from torch import nn

from se_snmf_nat_tpu_torch.config import PipelineConfig
from se_snmf_nat_tpu_torch.device import resolve_device
from se_snmf_nat_tpu_torch.dsp.mel import mel_matrix
from se_snmf_nat_tpu_torch.dsp.stft import (
    analysis_frames, dft_matrices_stacked, overlap_add, synthesis_frames)
from se_snmf_nat_tpu_torch.dsp.windows import sqrt_hann_periodic
from se_snmf_nat_tpu_torch.enhance.blk_sparse import (
    make_block_sparsity_q_block, snr_column)
from se_snmf_nat_tpu_torch.enhance.state import EngineState
from se_snmf_nat_tpu_torch.kernels.gain import (
    gain_consts, gain_scan_lanes, gain_scan_plain)
from se_snmf_nat_tpu_torch.kernels.mu import (
    captured_launches, count_replay, mu_h_solve_lanes, mu_w_solve_lanes)
from se_snmf_nat_tpu_torch.nmf.solver import (
    SnmfParams, snmf_h_solve_columns, snmf_solve)
from se_snmf_nat_tpu_torch.runtime.profiling import count
from se_snmf_nat_tpu_torch.utils.matlab_compat import matlab_v4_rand_matrix

H_SOLVE_FLR = 1e-9    # the solvers' floor in the reference plan (not
#                       signal.nonzerofloor, though equal by default)


def ring_ptr0(n_lanes: int, device=None) -> torch.Tensor:
    """Initial circular write pointer of every lane's rings."""
    return torch.zeros((n_lanes,), dtype=torch.int32, device=device)


def _roll_back(ring: torch.Tensor, ptr: torch.Tensor) -> torch.Tensor:
    """out[..., j] = ring[..., (j + ptr) % m] per lane: the chronological
    (oldest first) order of a ring written circularly up to ``ptr``."""
    m = ring.shape[-1]
    idx = (torch.arange(m, device=ring.device)[None, :]
           + ptr[:, None].to(torch.int64)) % m
    return torch.gather(ring, -1,
                        idx[:, None, :].expand(-1, ring.shape[-2], -1))


def rings_to_shift_layout(state: EngineState,
                          ptr: torch.Tensor) -> EngineState:
    """Rotate the circularly written rings of a batched state back to the
    exact engine's shift layout (oldest column first)."""
    return state._replace(lambda_d_blk=_roll_back(state.lambda_d_blk, ptr),
                          ad_blk=_roll_back(state.ad_blk, ptr))


def _push(ring: torch.Tensor, cols: torch.Tensor,
          pos: torch.Tensor) -> torch.Tensor:
    """Write cols[..., k] into ring slot pos[:, k] per lane; pos == m
    (untriggered frames) writes into a discarded slot."""
    b, rows, m = ring.shape
    ext = torch.cat([ring, ring.new_zeros((b, rows, 1))], dim=-1)
    ext.scatter_(-1, pos[:, None, :].expand(-1, rows, -1), cols)
    return ext[..., :m]


class BlockStep(nn.Module):
    """One K-frame block over all lanes:
    ``(state, ring_ptr, mag_blk (B, K, F), ls, ok_blk (B, K)) ->
    (state, ring_ptr, xm_tilde (B, K, F))``, with ``ls`` the block's 1-based
    frame numbers: an integer tensor, (K,) shared by every lane or (B, K)
    with a row per lane (host integers are taken as a (K,) tensor), and
    ``ok_blk`` each lane's true frames, a prefix of the block (the frames
    past a lane's end are padding and leave its state as it is).  Every
    branch on a frame number is a per-lane select, so the step reads no
    device value on the host outside the plain solvers.  K1 solves only the
    lanes with a true frame in the block (``ok_blk[:, 0]``): a block wholly
    past a lane's end feeds nothing that its output or state keeps.  Only
    batches padded to their longest lane (``enhance_batch``, ``BatchRunner``)
    have such blocks: push sessions and fleets give every lane a full block
    (an all-true ``ok_blk``), so K1 skips nothing there.

    ``h_solver`` and ``w_solver`` say ``"kernel"`` (float32, beta=1) or
    ``"plain"``: any other dtype, since the kernels are float32 only, and a
    beta other than 1, since they are KL only; the plain solves then take
    the config's beta, as the reference's do.  The kernel path also scans
    the gains with G (``kernels/gain.py``).

    On the card the kernel path runs as one CUDA graph a block: the step is
    captured once for each lane count and K (``_BlockGraph``, all of a
    step's graphs in one memory pool) and replayed for each block; a
    capture that fails raises.  ``eager`` is the step itself, which a
    comparison may call in the graph's place.  Counters: ``block.steps``
    (the blocks stepped, every route) and ``block.steps_graphed`` (those
    of them stepped by a graph's replay), host integers."""

    def __init__(self, cfg: PipelineConfig, b1_x, b1_d, b2_x=None, b2_d=None,
                 device=None, dtype=torch.float32, k_block: int = 16,
                 iter_cap: int = 0, refit_iter_cap: int = 0,
                 fixed_iter: bool = False):
        super().__init__()
        device = resolve_device(device)
        s, sep, ad, blk = cfg.signal, cfg.sep, cfg.adapt, cfg.blk
        if sep.basis_update_n or sep.basis_update_e:
            raise ValueError("block-adaptive plan: supervised configs only")
        self.cfg = cfg
        self.k_block = k_block
        self.beta = cfg.nmf.beta
        self.h_solver = self.w_solver = (
            "kernel" if dtype == torch.float32 and self.beta == 1.0
            else "plain")
        self.gain_consts = gain_consts(cfg)
        self._use_graph = (self.h_solver == "kernel"
                           and torch.device(device).type == "cuda")
        self._graphs: dict[tuple[int, int], _BlockGraph] = {}
        self._pool = None                   # the graphs' one memory pool
        self.mel_mode = sep.b_sep_mode == "Mel"
        r_x, r_a = sep.r_x, ad.r_a
        r = r_x + sep.r_d

        def t(a):
            return torch.as_tensor(a, dtype=dtype, device=device)

        self.register_buffer("bx", t(b1_x))
        self.register_buffer("bd_tail", t(b1_d)[:, r_a:].contiguous())
        # Mel mode: the (F_mel, F) filterbank, and the DFT bases that
        # reconstruct when the mel->DFT conversion is off
        coupled = self.mel_mode and not sep.mel_conv
        self.register_buffer("melmat", t(mel_matrix(
            s.fs, s.f_order, s.fftlength, 1.0, s.fs / 2).T)
            if self.mel_mode else None)
        self.register_buffer("bx_dft", t(b2_x) if coupled else None)
        self.register_buffer("bd_dft", t(b2_d) if coupled else None)
        self.register_buffer("h0_col",
                             t(matlab_v4_rand_matrix(r, 1,
                                                     cfg.nmf.random_seed)))
        eff_max_iter = (min(cfg.nmf.max_iter, iter_cap) if iter_cap
                        else cfg.nmf.max_iter)
        self.h_iters = eff_max_iter
        # fixed_iter drops the H-solves' early stop (and its per-trip cost)
        # when a cap is set; the refit keeps its early stop
        self.h_eps = (0.0 if fixed_iter and eff_max_iter < cfg.nmf.max_iter
                      else cfg.nmf.conv_eps)
        self.w_iters = (min(eff_max_iter, refit_iter_cap) if refit_iter_cap
                        else eff_max_iter)
        self.w_eps = cfg.nmf.conv_eps
        self.sparsity = float(cfg.nmf.sparsity)
        self.q_block = None
        if blk.enabled:
            self.q_block = make_block_sparsity_q_block(
                k_block, n_bins=s.n_bins, p_len_k=blk.p_len_k,
                p_len_l=blk.p_len_l, dc_bin=s.dc_bin, gap=blk.blk_gap,
                alpha_p=blk.alpha_p, device=device, dtype=dtype)

    def forward(self, state: EngineState, ring_ptr: torch.Tensor,
                mag_blk: torch.Tensor, ls, ok_blk: torch.Tensor):
        ls = torch.as_tensor(ls, device=mag_blk.device)
        count("block.steps", 1)
        if not self._use_graph:
            return self.eager(state, ring_ptr, mag_blk, ls, ok_blk)
        key = tuple(mag_blk.shape[:2])
        graph = self._graphs.get(key)
        if graph is None:
            # the first block of this shape runs eagerly: it is the
            # capture's warm-up, and its result is the block's
            out = self.eager(state, ring_ptr, mag_blk, ls, ok_blk)
            self._graphs[key] = _BlockGraph(self, state, ring_ptr, mag_blk)
            return out
        count("block.steps_graphed", 1)
        return graph(state, ring_ptr, mag_blk, ls, ok_blk)

    def eager(self, state: EngineState, ring_ptr: torch.Tensor,
              mag_blk: torch.Tensor, ls, ok_blk: torch.Tensor):
        """The block step, op by op (see the class)."""
        cfg = self.cfg
        s, sep, ad = cfg.signal, cfg.sep, cfg.adapt
        r_x, r_d, r_a, m_a = sep.r_x, sep.r_d, ad.r_a, ad.m_a
        flr = s.nonzerofloor
        n_lanes, k_block, _ = mag_blk.shape
        w_sep = torch.cat([self.bx.expand(n_lanes, -1, -1), state.b_d_head,
                           self.bd_tail.expand(n_lanes, -1, -1)], dim=-1)
        if self.mel_mode:
            ym_mel = torch.matmul(mag_blk, self.melmat.T)     # (B, K, F_mel)
            vn = torch.sqrt(torch.sum(ym_mel * ym_mel, dim=-1, keepdim=True))
            tn = torch.sqrt(torch.sum(mag_blk * mag_blk, dim=-1,
                                      keepdim=True))
            y_sep = (ym_mel / vn + 1e-9) * tn
        else:
            y_sep = mag_blk
        v_sep = y_sep.transpose(-1, -2).contiguous()
        h0 = self.h0_col.expand(-1, k_block).contiguous()
        if self.h_solver == "kernel":
            a, _ = mu_h_solve_lanes(v_sep, w_sep, h0, self.h_iters,
                                    self.h_eps, self.sparsity, H_SOLVE_FLR,
                                    active=ok_blk[:, 0])
        else:
            a = snmf_h_solve_columns(v_sep, w_sep, h0, SnmfParams(
                self.beta, self.sparsity, self.h_iters, self.h_eps,
                H_SOLVE_FLR)).h                                   # (B, R, K)
        # the l == 1 seed of the noise PSD: the raw DFT spectrum, or the
        # mel spectrum projected back where the reconstructions are
        ym_dft_blk = mag_blk
        if self.mel_mode and not sep.mel_conv:
            xm = torch.matmul(self.bx_dft, a[:, :r_x]).transpose(-1, -2)
            dm = torch.matmul(self.bd_dft, a[:, r_x:]).transpose(-1, -2)
        else:
            xm = torch.matmul(w_sep[..., :r_x], a[:, :r_x]).transpose(-1, -2)
            dm = torch.matmul(w_sep[..., r_x:], a[:, r_x:]).transpose(-1, -2)
            if self.mel_mode:
                xm = torch.matmul(xm, self.melmat)            # (B, K, F)
                dm = torch.matmul(dm, self.melmat)
                ym_dft_blk = torch.matmul(y_sep, self.melmat)
        a_d_mag = torch.sum(a[:, r_x:], dim=1) / r_d             # (B, K)
        a_x_mag = torch.sum(a[:, :r_x], dim=1) / r_x

        if self.q_block is not None:
            snr_blk = snr_column(xm, dm, flr)                  # (B, K, F)
            n_valid = torch.sum(ok_blk, dim=-1)
            q_blk, r_blk_new = self.q_block(snr_blk, state.r_blk, ls,
                                            n_valid)
        else:
            q_blk = torch.ones_like(mag_blk)
            r_blk_new = state.r_blk
        qc_blk = (1.0 - torch.mean(q_blk, dim=-1)) * ad.ar_up     # (B, K)

        # the per-frame gain scan: one launch of G on the kernel path
        scan = (gain_scan_lanes if self.h_solver == "kernel"
                else gain_scan_plain)
        g = scan(mag_blk, ym_dft_blk, xm, dm, q_blk, a_d_mag, a_x_mag,
                 qc_blk, ok_blk, ls, state.lambda_dav, state.xm_tilde,
                 state.update_switch, state.adapt_on, self.gain_consts)

        # ring push: the j-th triggered frame of the block lands in slot
        # (ptr + j) % m_a; with more than m_a triggers only the newest m_a
        # survive, as in a shift ring
        trig_i = g.trig_seq.to(torch.int64)
        rank = torch.cumsum(trig_i, dim=-1) - 1
        n_trig = torch.sum(trig_i, dim=-1)
        keep = g.trig_seq & (rank >= (n_trig - m_a)[:, None])
        pos = torch.where(keep, (ring_ptr[:, None] + rank) % m_a,
                          torch.full_like(rank, m_a))
        lam_blk = _push(state.lambda_d_blk, g.d_ref_seq, pos)
        ad_blk = _push(state.ad_blk, a[:, r_x: r_x + r_a], pos)
        ptr_out = ((ring_ptr + n_trig) % m_a).to(torch.int32)

        # one refit per block on the lanes where a frame scheduled one,
        # from the rings in chronological order
        lam_s = _roll_back(lam_blk, ptr_out)
        ad_s = _roll_back(ad_blk, ptr_out)
        r_up = (g.qctl_last[:, None] * torch.mean(ad_s, dim=-1)
                > g.ax_last[:, None])                                # (B, R_a)
        head = state.b_d_head
        upf = r_up.to(head.dtype)
        target = torch.matmul(self.melmat, lam_s) if self.mel_mode else lam_s
        w0, h0a = head * upf[:, None, :], ad_s * upf[:, :, None]
        if self.w_solver == "kernel":
            w_new, _ = mu_w_solve_lanes(target, w0, h0a, g.any_refit,
                                        self.w_iters, self.w_eps,
                                        self.sparsity, H_SOLVE_FLR)
        else:
            w_new = snmf_solve(
                target, w0, h0a, r_up, torch.zeros_like(r_up),
                SnmfParams(self.beta, self.sparsity, self.w_iters,
                           self.w_eps, H_SOLVE_FLR),
                update_w=True, update_h=False, active=g.any_refit,
                need_stats=False).w
        merged = torch.where(r_up[:, None, :], w_new, head)
        perm = torch.argsort(r_up.to(torch.int32), dim=-1, stable=True)
        merged = torch.gather(merged, -1,
                              perm[:, None, :].expand(-1, head.shape[-2], -1))
        head_new = torch.where(g.any_refit[:, None, None], merged, head)
        new_state = state._replace(
            b_d_head=head_new, lambda_dav=g.lambda_dav,
            xm_tilde=g.xm_tilde, r_blk=r_blk_new, lambda_d_blk=lam_blk,
            ad_blk=ad_blk, update_switch=g.update_switch)
        return new_state, ptr_out, g.xm_tilde_seq


class _BlockGraph:
    """The kernel path's block step captured as one CUDA graph for one
    (lanes, K): static input buffers, the graph and its static outputs.

    A call copies the state, ring pointer, spectra, frame numbers ((K,) or
    (B, K): a (B, K) int64 buffer) and ``ok`` into the buffers, replays,
    counts the graph's launches of K1, K2 and G
    (``kernels.mu.count_replay``) and returns copies of the outputs, which
    the next replay overwrites.

    The graphs of one step share its memory pool: the static outputs of
    each stay allocated, and what one graph's replay overwrites of another's
    scratch, that graph writes afresh when it replays, since replays run
    one after another on the stream.

    The step captured is the one ``BlockStep.forward`` has just run
    eagerly on a block of this shape (the warm-up ``torch.cuda.graph``
    asks for: the kernel library's loading, each C launcher's first call
    with its attributes and occupancy queries, and cuBLAS's handles all
    happen outside the capture).  The capture runs nothing and counts
    nothing; the buffers start at zero."""

    def __init__(self, step: BlockStep, state: EngineState,
                 ring_ptr: torch.Tensor, mag_blk: torch.Tensor):
        dev = mag_blk.device
        b, k = mag_blk.shape[:2]
        self.inputs = (
            EngineState(*(torch.zeros_like(f, memory_format=torch.
                                           contiguous_format)
                          for f in state)),
            torch.zeros_like(ring_ptr),
            torch.zeros(mag_blk.shape, dtype=mag_blk.dtype, device=dev),
            torch.zeros((b, k), dtype=torch.int64, device=dev),
            torch.zeros((b, k), dtype=torch.bool, device=dev))
        self.device = dev
        with torch.cuda.device(dev):        # the capture stream's card
            if step._pool is None:
                step._pool = torch.cuda.graph_pool_handle()
            self.graph = torch.cuda.CUDAGraph()
            with torch.no_grad(), captured_launches() as tally, \
                    torch.cuda.graph(self.graph, pool=step._pool):
                self.outputs = step.eager(*self.inputs)
        self.launches = dict(tally)

    def _load(self, state, ring_ptr, mag_blk, ls, ok_blk) -> None:
        st, ptr, mag, frames, ok = self.inputs
        for dst, src in zip(st, state):
            dst.copy_(src)
        ptr.copy_(ring_ptr)
        mag.copy_(mag_blk)
        frames.copy_(ls)
        ok.copy_(ok_blk)

    def __call__(self, state, ring_ptr, mag_blk, ls, ok_blk):
        self._load(state, ring_ptr, mag_blk, ls, ok_blk)
        with torch.cuda.device(self.device):
            self.graph.replay()
        count_replay(self.launches)
        new_state, ptr, xm = self.outputs
        return (EngineState(*(f.clone() for f in new_state)), ptr.clone(),
                xm.clone())


def make_block_step(cfg: PipelineConfig, b1_x, b1_d, b2_x=None, b2_d=None,
                    device=None, dtype=torch.float32, k_block: int = 16,
                    iter_cap: int = 0, refit_iter_cap: int = 0,
                    fixed_iter: bool = False) -> BlockStep:
    """The K-frame block step, on the card unless ``device`` names another
    (``b2_*``, the DFT reconstruction bases, serve only the Mel mode without
    the mel->DFT conversion)."""
    return BlockStep(cfg, b1_x, b1_d, b2_x, b2_d, device, dtype, k_block,
                     iter_cap, refit_iter_cap, fixed_iter)


class BlockAdaptiveRun(nn.Module):
    """``run(frames (B, T, L), state0 (batched EngineState), t_valid (B,))
    -> (y (B, S), state)``: analysis, the block loop, synthesis and
    overlap-add.  T must be a multiple of K; frames past ``t_valid`` are
    padding and leave every lane's state untouched."""

    def __init__(self, cfg: PipelineConfig, step: BlockStep, device=None,
                 dtype=torch.float32, dft_matmul: bool = False):
        super().__init__()
        device = resolve_device(device)
        s = cfg.signal
        self.cfg = cfg
        self.step = step
        self.dft_matmul = dft_matmul
        self.register_buffer("win", torch.as_tensor(
            sqrt_hann_periodic(s.framelength), dtype=dtype, device=device))
        cs, cisi = dft_matrices_stacked(s.framelength, s.fftlength)
        self.register_buffer("cs", torch.as_tensor(cs, dtype=dtype,
                                                   device=device))
        self.register_buffer("cisi", torch.as_tensor(cisi, dtype=dtype,
                                                     device=device))

    def forward(self, frames: torch.Tensor, state0: EngineState,
                t_valid: torch.Tensor):
        s = self.cfg.signal
        k_block = self.step.k_block
        mag, phase = analysis_frames(
            frames, self.win, s.fftlength, s.pow, s.dc_bin, s.nonzerofloor,
            s.preemph, dft_matmul=self.dft_matmul, cs=self.cs)
        n_lanes, t = mag.shape[:2]
        if t % k_block:
            raise ValueError(
                f"block-adaptive run needs frame count divisible by "
                f"k_block={k_block}, got {t} (pad frames before calling)")
        ls = torch.arange(1, t + 1, device=mag.device)
        ok = ls[None, :] <= t_valid.to(mag.device)[:, None]       # (B, T)
        state = state0
        ptr = ring_ptr0(n_lanes, mag.device)
        blocks = []
        for b0 in range(0, t, k_block):
            state, ptr, xm_blk = self.step(
                state, ptr, mag[:, b0: b0 + k_block],
                ls[b0: b0 + k_block], ok[:, b0: b0 + k_block])
            blocks.append(xm_blk)
        state = rings_to_shift_layout(state, ptr)
        out_frames = synthesis_frames(
            torch.cat(blocks, dim=1), phase, s.framelength, s.fftlength,
            self.win, s.pow, s.dc_bin_back, s.overlapscale, s.preemph,
            dft_matmul=self.dft_matmul, cisi=self.cisi)
        return overlap_add(out_frames, s.frameshift), state


def make_block_adaptive_run(cfg: PipelineConfig, b1_x, b1_d, b2_x=None,
                            b2_d=None, device=None, dtype=torch.float32,
                            k_block: int = 16, iter_cap: int = 0,
                            dft_matmul: bool = False,
                            refit_iter_cap: int = 0,
                            fixed_iter: bool = False) -> BlockAdaptiveRun:
    """The block-adaptive run over lanes (see ``BlockAdaptiveRun``), on the
    card unless ``device`` names another."""
    device = resolve_device(device)
    step = make_block_step(cfg, b1_x, b1_d, b2_x, b2_d, device, dtype,
                           k_block, iter_cap, refit_iter_cap, fixed_iter)
    return BlockAdaptiveRun(cfg, step, device, dtype, dft_matmul)
