"""Spatial (row-sharded) partitioning of the VDP U-Net: the counterpart of
``supernet_tpu/parallel/spatial.py``.

The image's H axis (a volume's D axis) is split over the ranks of a mesh
dim; each rank holds a block of rows of every activation and computes the
output rows it owns. JAX lets GSPMD partition every window op behind a
per-block sharding constraint; here the bookkeeping is written out:

- a sharded activation (``_Rows``) is the rank's local tensors plus every
  rank's global row range, which all ranks know without talking;
- an op first decides which output rows each rank owns (an even split),
  then fetches the input rows those need from whichever ranks hold them
  (``_Exchange``: point-to-point ``batch_isend_irecv`` pairs; its backward
  sends each row's gradient back to the rank that owns the row, which adds
  it to its own), then runs the op locally: a VALID conv fetches ``k - 1``
  rows from below, a pool fetches the pairs of its windows so that every
  shard starts on an even global row (``vmaxpool`` pads an odd end, so an
  odd offset would pool the wrong windows), the unpool is local and
  doubles the rows, a pad adds rows at the global edges only, and the skip
  concatenation fetches the skip's rows in global coordinates; under the
  decoder glue fold (``glue_fold="fold"``) the pad, the concatenation and
  the conv are one op that fetches the decoder rows under its window and
  pads them only at the image's global top and bottom
  (``vglue_conv_relu`` with a ``(lo, hi)`` pad per axis);
- a level with fewer rows than ranks (the bottleneck of a deep split)
  leaves the last ranks with no rows: such a rank computes the last output
  row as well and drops it, so every rank runs the same ops in the same
  order (the collectives of the backward pass and of a recomputed block
  under ``cfg.remat`` meet in the same order everywhere) and the kernels
  never see an empty tensor.

The loss of a sharded step is the sum of each rank's local NLL over the
global pixel count, with the KL added on one rank; the weight gradients are
summed over the ranks and every rank applies the same bits.

``halo_exchange_rows``, ``make_spatial_vconv`` and
``make_spatial_encoder_block`` keep the JAX building blocks' contract:
equal shards of ``H_loc`` rows in, ``H_loc`` rows out, ``(k - 1) // 2``
zero-contaminated rows per global edge that ``trim_valid`` removes from the
assembled output.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from supernet_tpu_torch import losses, tracing
from supernet_tpu_torch.configs import ModelConfig, TrainConfig
from supernet_tpu_torch.parallel._comm import (
    Axis,
    all_reduce_sum_,
    axis,
    gather_rows,
    mesh_device,
)

Tensor = torch.Tensor
Range = Tuple[int, int]


# ------------------------------------------------------------ row exchange


def _split(n_rows: int, n_parts: int) -> List[Range]:
    """``n_parts`` contiguous row ranges covering ``[0, n_rows)`` as evenly
    as possible; the trailing ranges are empty when there are fewer rows
    than parts."""
    base, extra = divmod(n_rows, n_parts)
    out, lo = [], 0
    for r in range(n_parts):
        hi = lo + base + (r < extra)
        out.append((lo, hi))
        lo = hi
    return out


def _transfer(ax: Axis, x: Tensor, have: Sequence[Range], want: Sequence[Range]) -> Tensor:
    """Rows ``want[me]`` (dim 1) assembled from every rank's ``x``, which
    holds rows ``have[rank]``. Rows nobody holds are 0; a row several ranks
    send is summed (the backward of a fetch, where halos overlap)."""
    me = ax.index
    h_lo = have[me][0]
    w_lo, w_hi = want[me]
    out = x.new_zeros((x.shape[0], w_hi - w_lo) + tuple(x.shape[2:]))
    ops, recvs = [], []
    for p in range(ax.size):
        a, b = max(have[me][0], want[p][0]), min(have[me][1], want[p][1])
        if a < b:
            part = x[:, a - h_lo:b - h_lo]
            if p == me:
                out[:, a - w_lo:b - w_lo] += part
            else:
                ops.append(dist.P2POp(dist.isend, part.contiguous(), ax.ranks[p], ax.group))
        if p != me:
            a, b = max(have[p][0], w_lo), min(have[p][1], w_hi)
            if a < b:
                buf = x.new_empty((x.shape[0], b - a) + tuple(x.shape[2:]))
                ops.append(dist.P2POp(dist.irecv, buf, ax.ranks[p], ax.group))
                recvs.append((a, buf))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for a, buf in recvs:
        out[:, a - w_lo:a - w_lo + buf.shape[1]] += buf
    return out


class _Exchange(torch.autograd.Function):
    """Fetch rows between ranks; the backward returns each fetched row's
    gradient to the rank that holds the row, which adds it to its own."""

    @staticmethod
    def forward(ctx, ax, have, want, x):
        ctx.ax, ctx.have, ctx.want = ax, have, want
        return _transfer(ax, x.contiguous(), have, want)

    @staticmethod
    def backward(ctx, g):
        return None, None, None, _transfer(ctx.ax, g.contiguous(), ctx.want, ctx.have)


def _fetch(ax: Axis, xs: Sequence[Tensor], have: Sequence[Range],
           want: Sequence[Range]) -> Tuple[Tensor, ...]:
    """``_Exchange`` of like-shaped tensors as one message (stacked on the
    channel dim); the tensors themselves when nothing moves."""
    if list(have) == list(want):
        return tuple(xs)
    have, want = tuple(have), tuple(want)
    if len(xs) == 1:
        return (_Exchange.apply(ax, have, want, xs[0]),)
    c = xs[0].shape[-1]
    out = _Exchange.apply(ax, have, want, torch.cat(list(xs), dim=-1))
    return tuple(out[..., i * c:(i + 1) * c] for i in range(len(xs)))


def halo_exchange_rows(x: Tensor, mesh, axis_name: str = "data", halo: int = 1) -> Tensor:
    """Per-rank [B, H_loc, ...] -> [B, H_loc + 2*halo, ...]: the top halo is
    the previous rank's last rows, the bottom halo the next rank's first
    rows, zeros at the mesh's edges (the caller trims those globally). Every
    rank holds ``H_loc`` rows. Differentiable: a halo row's gradient is
    added to the row on the rank that owns it."""
    ax = axis(mesh, axis_name)
    h = x.shape[1]
    have = [(r * h, (r + 1) * h) for r in range(ax.size)]
    want = [(lo - halo, hi + halo) for lo, hi in have]
    return _fetch(ax, (x,), have, want)[0]


def make_spatial_vconv(mesh, axis_name: str = "data"):
    """Row-sharded VDP conv: ``f(mu, sigma, w_mu, w_sigma)`` on this rank's
    ``H_loc`` rows of both moments, weights replicated; returns ``H_loc``
    rows. ``trim_valid`` of the assembled output is the unsharded VALID
    conv."""
    from supernet_tpu_torch.ops import vconv

    def f(mu, sigma, w_mu, w_sigma):
        halo = (w_mu.shape[0] - 1) // 2
        if halo > mu.shape[1]:
            raise ValueError(
                f"per-device rows ({mu.shape[1]}) < halo ({halo}); use "
                "fewer devices or a larger input (a one-hop exchange "
                "cannot fetch rows beyond the nearest neighbor)"
            )
        mu = halo_exchange_rows(mu, mesh, axis_name, halo)
        sigma = halo_exchange_rows(sigma, mesh, axis_name, halo)
        return vconv(mu, sigma, w_mu, w_sigma)

    return f


def make_spatial_encoder_block(mesh, axis_name: str = "data"):
    """A row-sharded encoder block ``conv3+relu -> conv3+relu -> maxpool``:
    ``f(mu, sigma, w1, ws1, w2, ws2) -> (mu, sigma)`` on this rank's rows,
    one halo exchange per conv, the 2x2 pool shard-local (its windows never
    straddle a shard when the per-rank row count is even). The assembled
    output carries one garbage pooled row per global edge: ``trim_valid(y,
    k=3)``. Requires per-rank rows even and >= 4."""
    from supernet_tpu_torch.ops import vconv_relu, vmaxpool

    def f(mu, sigma, w1, ws1, w2, ws2):
        h_loc = mu.shape[1]
        if h_loc % 2 != 0 or h_loc < 4:
            raise ValueError(
                f"per-device rows ({h_loc}) must be even and >= 4 for the "
                "shard-local 2x2 pool to align with the global pool grid"
            )
        for w, ws in ((w1, ws1), (w2, ws2)):
            mu, sigma = vconv_relu(halo_exchange_rows(mu, mesh, axis_name),
                                   halo_exchange_rows(sigma, mesh, axis_name), w, ws)
        return vmaxpool(mu, sigma)

    return f


def trim_valid(y: Tensor, k: int = 3) -> Tensor:
    """Drop the ``(k-1)//2`` zero-halo-contaminated rows at the global top
    and bottom of an assembled sharded conv output."""
    t = (k - 1) // 2
    return y[:, t:y.shape[1] - t]


# ------------------------------------------------------ the sharded U-Net


@dataclass
class _Rows:
    """A row-sharded activation: this rank's tensors (rows on dim 1), every
    rank's global row range, and the global row count."""

    ts: Tuple[Tensor, ...]
    ranges: Tuple[Range, ...]
    n: int


def _family(three_d: bool) -> Dict[str, Callable]:
    """The moment ops of one model family, looked up at call time (the
    seams a replay patches stay in force)."""
    if three_d:
        from supernet_tpu_torch.ops import moments3d as M

        return {
            "conv_input": lambda *a: M.vconv3d_input_relu(*a),
            "conv_relu": lambda *a: M.vconv3d_relu(*a),
            "conv": lambda *a: M.vconv3d(*a),
            "pool": lambda *a: M.vmaxpool3d(*a),
            "pad": lambda *a: M.vpad3d(*a),
            "unpool": lambda *a: M.vunpool3d_conv2(*a),
            "concat": lambda *a: M.vcrop_concat3d(*a),
            "glue": lambda *a: M.vglue_conv3d_relu(*a),
            "softmax": lambda *a: M.vsoftmax3d(*a),
        }
    from supernet_tpu_torch.ops import moments as M

    return {
        "conv_input": lambda *a: M.vconv_input_relu(*a),
        "conv_relu": lambda *a: M.vconv_relu(*a),
        "conv": lambda *a: M.vconv(*a),
        "pool": lambda *a: M.vmaxpool(*a),
        "pad": lambda *a: M.vpad(*a),
        "unpool": lambda *a: M.vunpool_conv2(*a),
        "concat": lambda *a: M.vcrop_concat(*a),
        "glue": lambda *a: M.vglue_conv_relu(*a),
        "softmax": lambda *a: M.vsoftmax(*a),
    }


class _RowNet:
    """The U-Net forward (``models.forward`` / ``forward3d``: the same block
    choreography) on row-sharded activations over the mesh dim ``ax``."""

    def __init__(self, cfg: ModelConfig, ax: Axis, three_d: bool):
        if type(cfg) is not ModelConfig:
            raise NotImplementedError(
                "the row-split forward follows the SUPER-Net schedule; the "
                "Cicek, Swin UNETR and MedNeXt layer plans run on one device or "
                "batch-sharded")
        self.cfg, self.ax, self.three_d = cfg, ax, three_d
        self.ops = _family(three_d)

    # -- row ops ---------------------------------------------------------

    def _compute(self, own: List[Range], n_out: int) -> List[Range]:
        """The rows each rank computes: its own, or the last row when it
        owns none (computed and dropped, see the module docstring)."""
        return [(lo, hi) if hi > lo else (n_out - 1, n_out) for lo, hi in own]

    def _take(self, outs, own: List[Range], comp: List[Range], n_out: int) -> _Rows:
        (lo, hi), c_lo = own[self.ax.index], comp[self.ax.index][0]
        return _Rows(tuple(o[:, lo - c_lo:hi - c_lo] for o in outs), tuple(own), n_out)

    def fetch(self, rows: _Rows, want: Sequence[Range]) -> Tuple[Tensor, ...]:
        return _fetch(self.ax, rows.ts, rows.ranges, want)

    def input_rows(self, x: Tensor) -> _Rows:
        """This rank's block of the even split of ``x``'s rows."""
        ranges = _split(x.shape[1], self.ax.size)
        lo, hi = ranges[self.ax.index]
        return _Rows((x[:, lo:hi],), tuple(ranges), x.shape[1])

    def conv(self, rows: _Rows, op: str, w_mu: Tensor, w_sigma: Tensor) -> _Rows:
        k = w_mu.shape[0]
        n_out = rows.n - k + 1
        own = _split(n_out, self.ax.size)
        comp = self._compute(own, n_out)
        xs = self.fetch(rows, [(lo, hi + k - 1) for lo, hi in comp])
        return self._take(self.ops[op](*xs, w_mu, w_sigma), own, comp, n_out)

    def pool(self, rows: _Rows) -> _Rows:
        n_out = -(-rows.n // 2)
        own = _split(n_out, self.ax.size)
        comp = self._compute(own, n_out)
        xs = self.fetch(rows, [(2 * lo, min(2 * hi, rows.n)) for lo, hi in comp])
        return self._take(self.ops["pool"](*xs), own, comp, n_out)

    def unpool(self, rows: _Rows, w_mu: Tensor, w_sigma: Tensor) -> _Rows:
        # output row r of the zero-interleave unpool + 2x2 VALID conv reads
        # input row r // 2 alone: a block of input rows [a, b) gives output
        # rows [2a, 2b) with no neighbour
        n_out = 2 * rows.n
        own = _split(n_out, self.ax.size)
        comp = self._compute(own, n_out)
        need = [(lo // 2, (hi + 1) // 2) for lo, hi in comp]
        xs = self.fetch(rows, need)
        outs = self.ops["unpool"](*xs, w_mu, w_sigma)
        shift = comp[self.ax.index][0] - 2 * need[self.ax.index][0]
        outs = tuple(o[:, shift:] for o in outs)
        return self._take(outs, own, comp, n_out)

    def pad(self, rows: _Rows, pad, fill: float) -> _Rows:
        """``vpad`` of the global tensor: the spatial dims after the rows
        locally, the rows at the global edges only."""
        p0, p1 = int(pad[0]), int(pad[1])
        m, s = self.ops["pad"](*rows.ts, (p0, p1), fill)
        lo, hi = rows.ranges[self.ax.index]
        top = p0 if (lo == 0 and hi > 0) else 0
        bottom = p1 if (hi == rows.n and hi > lo) else 0
        keep = slice(p0 - top, p0 + (hi - lo) + bottom)
        ranges = tuple(
            (0 if l == 0 and h > 0 else l + p0,
             h + p0 + (p1 if h == rows.n and h > l else 0)) if h > l
            else (rows.n + p0 + p1,) * 2
            for l, h in rows.ranges
        )
        return _Rows((m[:, keep], s[:, keep]), ranges, rows.n + p0 + p1)

    def concat(self, dec: _Rows, skip: _Rows) -> _Rows:
        """``vcrop_concat``: the skip's rows at the decoder's rows' global
        places (center crop offset), cropped on the other dims locally."""
        off = (skip.n - dec.n) // 2
        ms, ss = self.fetch(skip, [(lo + off, hi + off) for lo, hi in dec.ranges])
        return _Rows(self.ops["concat"](*dec.ts, ms, ss), dec.ranges, dec.n)

    def glue(self, rows: _Rows, pad, fill: float, w_mu: Tensor, w_sigma: Tensor,
             skip: Optional[_Rows] = None) -> _Rows:
        """The glue fold's ``vpad -> [concat ->] conv -> relu`` in one
        (``vglue_conv_relu``): a block of output rows reads the decoder rows
        under its window, which the fold pads only on a side that is the
        image's global top or bottom (the other axes locally), and the
        skip's rows at their global places (the center-crop offset)."""
        k = w_mu.shape[0]
        p0, p1 = int(pad[0]), int(pad[1])
        n_pad = rows.n + p0 + p1
        n_out = n_pad - k + 1
        own = _split(n_out, self.ax.size)
        # a window that lies wholly in a pad widens toward the image, so
        # that every rank's conv reads at least one decoder row
        comp = [(min(lo, rows.n + p0 - 1), max(hi, p0 - k + 2))
                for lo, hi in self._compute(own, n_out)]
        # the window of output rows [a, b) is padded rows [a, b + k - 1),
        # decoder rows p0 lower
        want = [(max(a - p0, 0), min(b + k - 1 - p0, rows.n)) for a, b in comp]
        m, s = self.fetch(rows, want)
        (a, b), (r0, r1) = comp[self.ax.index], want[self.ax.index]
        pads = ((r0 + p0 - a, b + k - 1 - p0 - r1),) + ((p0, p1),) * (m.dim() - 3)
        enc = (None, None)
        if skip is not None:
            off = (skip.n - n_pad) // 2
            enc = self.fetch(skip, [(lo + off, hi + k - 1 + off) for lo, hi in comp])
        return self._take(self.ops["glue"](m, s, w_mu, w_sigma, pads, fill, *enc),
                          own, comp, n_out)

    # -- the model -------------------------------------------------------

    def forward(self, params, x: Tensor) -> Tuple[Tensor, Tensor, _Rows]:
        """``(probs, sigma)`` of this rank's output rows, flattened like the
        model's ([B, rows * W(*H), C]), and the output's ``_Rows`` layout."""
        from supernet_tpu_torch.ops.moments import glue_fold_active

        cfg = self.cfg
        depth, fill = cfg.depth, cfg.sigma_fill
        remat = cfg.remat and torch.is_grad_enabled()
        fold = glue_fold_active()

        def layer(rows, op, name):
            p = params[name]
            with tracing.span(name):
                return self.conv(rows, op, p["w_mu"], p["w_sigma"])

        def glue(rows, pad, name, skip=None):
            p = params[name]
            with tracing.span(name):
                return self.glue(rows, pad, fill, p["w_mu"], p["w_sigma"], skip)

        def block(fn, *args):
            if not remat:
                return fn(*args)
            return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)

        def encoder_block(i, rows):
            if i == depth - 1 and cfg.bottleneck_pre_pad is not None:
                if fold:
                    rows = glue(rows, cfg.bottleneck_pre_pad, f"conv{2 * i}")
                    return layer(rows, "conv_relu", f"conv{2 * i + 1}")
                rows = self.pad(rows, cfg.bottleneck_pre_pad, fill)
            rows = layer(rows, "conv_relu", f"conv{2 * i}")
            return layer(rows, "conv_relu", f"conv{2 * i + 1}")

        def decoder_block(j, rows, skip):
            p = params[f"up{j}_conv2x2"]
            with tracing.span(f"up{j}_conv2x2"):
                rows = self.unpool(rows, p["w_mu"], p["w_sigma"])
            if fold:
                rows = glue(rows, (3, 3), f"up{j}_conv1", skip)
                return glue(rows, (2, 2), f"up{j}_conv2")
            rows = self.pad(rows, (3, 3), fill)
            rows = self.concat(rows, skip)
            rows = layer(rows, "conv_relu", f"up{j}_conv1")
            rows = self.pad(rows, (2, 2), fill)
            return layer(rows, "conv_relu", f"up{j}_conv2")

        rows = layer(self.input_rows(x), "conv_input", "conv_input")
        rows = layer(rows, "conv_relu", "conv1")
        skips: List[_Rows] = []
        for i in range(depth):
            if i > 0:
                rows = block(encoder_block, i, rows)
            if i < depth - 1:
                skips.append(rows)
                rows = self.pool(rows)
        for j in range(1, depth):
            rows = block(decoder_block, j, rows, skips[depth - 1 - j])
        rows = layer(rows, "conv", "conv_final")
        probs, sigma = self.ops["softmax"](*rows.ts)
        return probs, sigma, rows

    def pixels_per_row(self, rows: _Rows) -> int:
        """Flattened pixels per global row of an output layout."""
        m = rows.ts[0]
        return m.shape[2] * (m.shape[3] if self.three_d else 1)

    def flat_range(self, rows: _Rows) -> slice:
        """This rank's output rows as a slice of the flattened pixels."""
        lo, hi = rows.ranges[self.ax.index]
        per = self.pixels_per_row(rows)
        return slice(lo * per, hi * per)

    def gather(self, t: Tensor, rows: _Rows) -> Tensor:
        """A flattened local output gathered into the whole [B, N, C]."""
        per = self.pixels_per_row(rows)
        return gather_rows(t, [(hi - lo) * per for lo, hi in rows.ranges], self.ax, dim=1)


# -------------------------------------------------------- sharded objective


def _nll_parts(y1: Tensor, probs: Tensor, sigma: Tensor, clip: Tuple[float, float],
               n_pix: int, ax: Axis):
    """The rank's share of ``nll_gaussian`` over the global pixels: its
    local sums over the global count (the part to differentiate), and the
    global NLL's value. The NaN/Inf scrub of the quadratic term acts on the
    global mean, as in the unsharded loss."""
    sig = losses.clip_sigma(sigma, *clip)
    eps = losses.NLL_EPS
    l1 = ((probs - y1) ** 2 / (sig + eps)).sum()
    l2 = torch.log(sig + eps).sum()
    tot = torch.stack([l1.detach(), l2.detach()])
    all_reduce_sum_([tot], ax)
    finite = torch.isfinite(tot[0] / n_pix)
    part = 0.5 * (torch.where(finite, l1 / n_pix, 0.0) + l2 / n_pix)
    value = 0.5 * (torch.where(finite, tot[0] / n_pix, 0.0) + tot[1] / n_pix)
    return part, value


class _Objective:
    """The sharded training objective of one batch (this rank's rows of
    it): ``elbo`` gives the rank's part and the global values, ``adv`` the
    adversarial examples of its rows."""

    def __init__(self, net: _RowNet, cfg: ModelConfig, tc: TrainConfig, y1: Tensor):
        self.net, self.cfg, self.tc = net, cfg, tc
        self.y1 = y1  # the whole batch's one-hot labels [B, N, C]
        self.n_pix = y1.shape[0] * y1.shape[1]

    def _labels(self, rows: _Rows) -> Tensor:
        return self.y1[:, self.net.flat_range(rows)]

    def elbo(self, params, x: Tensor, kl: Tensor, kl_here: bool):
        tc, ax = self.tc, self.net.ax
        probs, sigma, rows = self.net.forward(params, x)
        y1 = self._labels(rows)
        part, nll = _nll_parts(y1, probs, sigma, (tc.sigma_clip_min, tc.sigma_clip_max),
                               self.n_pix, ax)
        kl_term = tc.kl_factor * 0.5 * kl
        if kl_here:
            part = part + kl_term
        hits = (probs.detach().argmax(-1) == y1.argmax(-1)).sum().float().reshape(1)
        all_reduce_sum_([hits], ax)
        return part, nll + kl_term.detach(), nll, hits[0] / self.n_pix

    def adversarial(self, params, x: Tensor, x_range) -> Tensor:
        """FGSM / PGD examples against the current parameters
        (``train.make_adversarial_examples``), from the gradient of the
        sharded attack loss with respect to the rank's rows of ``x``."""
        from supernet_tpu_torch.configs import AttackConfig

        tc, ax = self.tc, self.net.ax
        ac = AttackConfig(epsilon=tc.adv_epsilon, step_size=tc.adv_step_size,
                          max_adv_step=tc.adv_steps)
        frozen = {k: {n: t.detach() for n, t in v.items()} for k, v in params.items()}
        lo_r, hi_r = x_range

        def sign(xa):
            with torch.enable_grad():
                xa = xa.detach().requires_grad_(True)
                probs, sigma, rows = self.net.forward(frozen, xa)
                part, _ = _nll_parts(self._labels(rows), probs, sigma,
                                     (ac.sigma_clip_min, ac.sigma_clip_max), self.n_pix, ax)
                (g,) = torch.autograd.grad(0.5 * part, xa)
            return torch.sign(g)

        x = x.detach()
        if tc.adversarial_training == "fgsm":
            return torch.clamp(x + ac.epsilon * sign(x), lo_r, hi_r)
        if tc.adversarial_training != "pgd":
            raise ValueError(
                f"unknown adversarial_training mode {tc.adversarial_training!r}"
            )
        adv = x
        for _ in range(ac.max_adv_step):
            adv = adv + ac.step_size * sign(adv)
            adv = torch.clamp(adv, x - ac.epsilon, x + ac.epsilon)
            adv = torch.clamp(adv, lo_r, hi_r)
        return adv


def make_rows_step(cfg: ModelConfig, tc: TrainConfig, mesh, space_axis: str,
                   data_axis: Optional[str] = None, three_d: bool = False):
    """``step(state, x, y) -> (state, metrics)`` for the whole batch ``x``,
    ``y`` on every rank: the rows of the image (volume) over ``space_axis``,
    and with ``data_axis`` the batch over that dim too (each data group
    takes its block of the batch, augmented with its global offset). The
    weight gradient is summed over ``space_axis`` and averaged over
    ``data_axis``; the KL enters once."""
    from supernet_tpu_torch.models import kl_regularizer, kl_regularizer3d
    from supernet_tpu_torch.parallel.data_parallel import global_range
    from supernet_tpu_torch.train import (
        StepMetrics,
        _to_device,
        _update,
        ensure_one_hot,
        leaves,
        maybe_augment,
        one_hot_flatten,
    )

    sp = axis(mesh, space_axis)
    dp = axis(mesh, data_axis) if data_axis is not None else None
    net = _RowNet(cfg, sp, three_d)
    kl_fn = kl_regularizer3d if three_d else kl_regularizer

    def augment(step, x, y, offset):
        if tc.augment is None:
            return x, y
        if three_d:
            from supernet_tpu_torch.data.augment import _mix, augment_volumes

            with torch.no_grad():
                return augment_volumes(_mix(tc.seed, step), x, y, tc.augment, offset)
        return maybe_augment(step, x, y, cfg, tc, index_offset=offset)

    def step(state, x, y):
        x, y = _to_device(state.params, x, y)
        offset = 0
        if dp is not None:
            per = len(x) // dp.size
            if per * dp.size != len(x):
                raise ValueError(f"batch {len(x)} must divide over the "
                                 f"{dp.size}-rank data dim")
            offset = dp.index * per
            x, y = x[offset:offset + per], y[offset:offset + per]
        x, y = augment(state.step, x, y, offset)
        y1 = (one_hot_flatten if three_d else ensure_one_hot)(y, cfg.n_classes)
        obj = _Objective(net, cfg, tc, y1)
        state.opt_state.zero_grad(set_to_none=True)
        kl = kl_fn(state.params)
        kl_here = sp.index == 0
        part, loss_v, nll_v, acc = obj.elbo(state.params, x, kl, kl_here)
        if not three_d and tc.adversarial_training != "none":
            x_range = (x.min(), x.max()) if dp is None else global_range(x, dp)
            adv = obj.adversarial(state.params, x, x_range)
            part_a, loss_a, _, _ = obj.elbo(state.params, adv, kl, kl_here)
            part = tc.adv_alpha * part + (1.0 - tc.adv_alpha) * part_a
            loss_v = tc.adv_alpha * loss_v + (1.0 - tc.adv_alpha) * loss_a
        part.backward()
        grads = [t.grad for t in leaves(state.params)]
        all_reduce_sum_(grads, sp)
        metrics = torch.stack([loss_v.reshape(()), nll_v.reshape(()), acc.reshape(())])
        if dp is not None:
            all_reduce_sum_(grads + [metrics], dp)
            for g in grads:
                g.div_(dp.size)
            metrics = metrics / dp.size
        _update(state, tc)
        if three_d:
            with torch.no_grad():
                kl = kl_fn(state.params)
        return state, StepMetrics(metrics[0], metrics[1], kl.detach(), metrics[2])

    return step


def make_rows_forward(cfg: ModelConfig, mesh, space_axis: str,
                      data_axis: Optional[str] = None, three_d: bool = False):
    """``f(params, x) -> (probs, sigma)``: the whole batch's outputs on
    every rank, from the rows over ``space_axis`` (and the batch over
    ``data_axis``), gathered."""
    sp = axis(mesh, space_axis)
    dp = axis(mesh, data_axis) if data_axis is not None else None
    net = _RowNet(cfg, sp, three_d)

    @torch.no_grad()
    def f(params, x):
        x = torch.as_tensor(x, dtype=torch.float32, device=mesh_device(mesh))
        b = len(x)
        if dp is not None:
            from supernet_tpu_torch.parallel.data_parallel import pad_rows

            x = pad_rows(x, dp.size)
            per = len(x) // dp.size
            x = x[dp.index * per:(dp.index + 1) * per]
        probs, sigma, rows = net.forward(params, x)
        out = [net.gather(probs, rows), net.gather(sigma, rows)]
        if dp is not None:
            out = [gather_rows(t, [len(t)] * dp.size, dp)[:b] for t in out]
        return out[0], out[1]

    return f


def make_spatial_forward(cfg, mesh, axis_name: str = "data"):
    """The whole U-Net forward with the image's H axis split over the
    mesh: ``f(params, x) -> (probs, sigma)`` for the whole batch ``x``
    (every rank passes it and takes its rows), flattened like ``forward``,
    the same on every rank."""
    return make_rows_forward(cfg, mesh, axis_name)


def make_spatial_train_step(cfg, tc, mesh, axis_name: str = "data"):
    """The training step with the image's H axis split over the mesh
    (forward and backward): ``step(state, x, y) -> (state, metrics)`` for
    the whole batch on every rank, augmented identically everywhere;
    activation memory per rank scales ~1/n while the parameters and the
    optimizer state stay replicated."""
    return make_rows_step(cfg, tc, mesh, axis_name)


def make_spatial_forward3d(cfg, mesh, axis_name: str = "data"):
    """Volumetric forward with the D (scan) axis split over the mesh:
    whole-volume inference whose activations do not fit one device."""
    return make_rows_forward(cfg, mesh, axis_name, three_d=True)


def make_spatial_train_step3d(cfg, tc, mesh, axis_name: str = "data"):
    """Volumetric training step with the D axis split over the mesh (the
    3-D twin of ``make_spatial_train_step``; the augmentation and objective
    of ``train3d._train_step3d``)."""
    return make_rows_step(cfg, tc, mesh, axis_name, three_d=True)
