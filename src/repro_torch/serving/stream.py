"""Frame-incremental streaming inference over the folded KWS model.

Port of ``repro/serving/stream.py``.  The accelerator is always-on: one
decision per hop of a sliding window.  Every layer's activation columns
are indexed by absolute time; when the hop is a multiple of
``hop_alignment(cfg)`` (the product of all strides and pool windows, 64
samples for the paper net), consecutive windows' overlapping columns are
identical at every layer, so per hop each layer computes only its tail:
the hop's fresh columns plus a small carry (the k-1 conv overlap and,
where a layer's conv length is odd, the one column the previous window's
OR-maxpool truncated).

SA noise is drawn from the per-absolute-column field of
``core.sa_noise``: ``fold_in(fold_in(stream_key, layer), abs_col)``, each
stream's key riding in its state.  A column keeps the realization it was
evaluated with while it is cached, and an offline window that evaluates
the same field (``window_sa_noise``, ``hw_forward(sa_noise_field=...)``)
reproduces the stream.  A hop evaluates all its layers' fresh columns in
one batched hash (``hop_sa_noise_fields``).

N hops of ``stream_step`` equal ``models.kws.hw_forward`` on each full
window, bit for bit, noise and chip offsets included.  A ``stream_step``
over B streams launches the fused kernel exactly once per IMC layer
(conv1..conv5) whatever B is;
``stream_multi_step`` advances n consecutive hops in the same single
launch per layer (the VAD wake replay).  ``gated_step`` advances a silent
hop without launching anything: each layer's constant silence response
(or, with ``retention_fills``, its retained noisy read) shifts into the
carries and the GAP ring.

The customization riders (``serving.customize``) ride the same launches:
``bias_delta`` ({conv_i: (B, C_i)}) holds each stream's integer bias
change from bias compensation and enters the kernel's pre-sign operand,
exactly where the word-line bias lands, so a customized stream's IMC
layers run in the same batched launch as every other stream;
``head_w``/``head_b`` ((B, D, C), (B, C)) replace the shared FC per
stream.  Both are exact on the fixed-point grids, so a row holding the
base values gives the base logits bit for bit.

``streaming=False`` selects the recompute path (``window_init``,
``window_step``, ``window_multi_step``, ``gated_window_step`` over a
``WindowState`` that holds the raw window): every hop is one
``hw_forward`` over the B full windows, one fused-kernel launch per IMC
layer, equal to the streaming path bit for bit with ~window/hop times
its work.  Its multi-hop step loops over the hops, so a run of n hops
launches n times per layer.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import jaxrand, means
from repro_torch.core.quantize import ACT_Q
from repro_torch.core.sa_noise import (SANoiseField, columns_noise,
                                       field_window_noise, sa_noise_columns)
from repro_torch.kernels import resolve_device
from repro_torch.models import kws

# ---------------------------------------------------------------------------
# Geometry: what each layer computes per hop
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerGeom:
    """Static per-layer streaming geometry (one hop).

    t_in/t_conv/t_out: full-window input / conv / post-pool lengths;
    d_in/d_out: fresh input/output columns per hop; conv_lo: local conv
    column where the per-hop tail starts (pool-aligned); tail_in: input
    columns consumed per hop; carry = tail_in - d_in: columns cached
    across hops."""

    t_in: int
    t_conv: int
    t_out: int
    d_in: int
    d_out: int
    conv_lo: int
    tail_in: int
    carry: int


@dataclasses.dataclass(frozen=True)
class StreamGeometry:
    window: int
    hop: int
    layers: Tuple[LayerGeom, ...]          # one per conv layer (0..5)

    @property
    def t_feat(self) -> int:
        """Final layer's pooled length — the GAP ring extent."""
        return self.layers[-1].t_out

    @property
    def d_feat(self) -> int:
        """Fresh final-layer columns per hop (GAP ring shift)."""
        return self.layers[-1].d_out


def hop_alignment(cfg: kws.KWSConfig) -> int:
    """Smallest hop (in samples) with full column reuse: the product of
    all strides and pool windows (64 for the paper net)."""
    a = 1
    for i in range(cfg.num_conv_layers):
        a *= cfg.strides[i] * cfg.pools[i]
    return a


def make_stream_geometry(cfg: kws.KWSConfig, hop: int) -> StreamGeometry:
    """Per-layer tail/carry geometry for a hop size.  Raises if ``hop`` is
    not a positive multiple of ``hop_alignment(cfg)`` or is too large or
    small to give every layer at least one fresh column."""
    align = hop_alignment(cfg)
    if hop % align or hop <= 0:
        raise ValueError(
            f"hop={hop} must be a positive multiple of {align} "
            f"(prod of strides*pools) for bit-exact column reuse")
    if hop >= cfg.sample_len:
        raise ValueError(f"hop={hop} must be smaller than the "
                         f"window ({cfg.sample_len})")
    layers = []
    t_in, d_in = cfg.sample_len, hop
    for i in range(cfg.num_conv_layers):
        k, s, p = cfg.kernels[i], cfg.strides[i], cfg.pools[i]
        t_conv = (t_in - k) // s + 1
        t_out = t_conv // p
        d_out = d_in // s // p             # fresh pooled columns per hop
        if d_out < 1 or d_out > t_out:
            raise ValueError(
                f"layer {i}: hop yields {d_out} fresh columns of {t_out} — "
                f"hop/window ratio unusable at this depth")
        conv_lo = p * (t_out - d_out)      # pool-aligned tail start
        tail_in = t_in - s * conv_lo
        layers.append(LayerGeom(t_in=t_in, t_conv=t_conv, t_out=t_out,
                                d_in=d_in, d_out=d_out, conv_lo=conv_lo,
                                tail_in=tail_in, carry=tail_in - d_in))
        t_in, d_in = t_out, d_out
    return StreamGeometry(window=cfg.sample_len, hop=hop,
                          layers=tuple(layers))


# ---------------------------------------------------------------------------
# The per-absolute-column SA-noise field, in the hop geometry
# ---------------------------------------------------------------------------


def window_sa_noise(key: torch.Tensor, cfg: kws.KWSConfig,
                    geom: StreamGeometry, hop_index: int,
                    std: float) -> Dict[str, torch.Tensor]:
    """The full-window view of the field: per-layer (1, t_conv, C) values
    of stream ``key`` (2,) at window ``hop_index``, in the
    ``hw_forward(sa_noise=...)`` layout: the offline oracle of the
    stream's noise."""
    return field_window_noise(SANoiseField(
        key[None], torch.tensor([hop_index], device=key.device), std,
        geom.hop), cfg)


def _tail_cols(geom: StreamGeometry, cfg: kws.KWSConfig, layer: int,
               hops: torch.Tensor, n_hops: int) -> torch.Tensor:
    """Absolute conv columns of layer ``layer``'s tail for a run of
    ``n_hops`` hops starting at window ``hops`` (B,): (B, n_tail)."""
    lg = geom.layers[layer]
    n_new = lg.d_out * cfg.pools[layer]
    n_tail = lg.t_conv - lg.conv_lo + (n_hops - 1) * n_new
    return (hops.to(torch.int64)[:, None] * n_new + lg.conv_lo
            + torch.arange(n_tail, device=hops.device))


def _hop_sa_noise(keys: torch.Tensor, hops: torch.Tensor, layer: int,
                  cfg: kws.KWSConfig, geom: StreamGeometry,
                  std: float) -> torch.Tensor:
    """Field values of one hop's tail conv columns of one layer, batched
    over streams: keys (B, 2), hops (B,) -> (B, t_conv_tail, C)."""
    return sa_noise_columns(keys, layer, _tail_cols(geom, cfg, layer, hops,
                                                    1),
                            cfg.channels[layer], std)


def hop_sa_noise_fields(keys: torch.Tensor, hops: torch.Tensor,
                        cfg: kws.KWSConfig, geom: StreamGeometry,
                        std: float, n_hops: int = 1
                        ) -> Dict[str, torch.Tensor]:
    """All IMC layers' tail field values for a hop in one batched
    evaluation: keys (B, 2), hops (B,) -> {conv_i: (B, n_tail_i, C_i)}.
    ``n_hops > 1`` extends each tail over a run of consecutive hops (the
    wake replay's multi-hop launch).  Bit-identical to ``_hop_sa_noise``
    per layer and per hop: the field is per absolute column."""
    cols = {i: _tail_cols(geom, cfg, i, hops, n_hops)
            for i in range(1, cfg.num_conv_layers)}
    out = columns_noise(keys, cols, cfg.channels, std)
    return {f"conv{i}": v for i, v in out.items()}


# ---------------------------------------------------------------------------
# Stream state + init/step
# ---------------------------------------------------------------------------


class StreamState(NamedTuple):
    """Per-stream incremental state (leading axis = batch of streams).

    ``audio_carry``/``carries`` are the layers' ring tails (the only
    activation columns that survive a hop); ``ring`` is the final layer's
    pooled window, feeding GAP; ``hop`` counts decided windows (window t's
    columns live at absolute index t*shift + local); ``key`` is the
    per-stream noise-field key (``core.jaxrand`` words)."""

    audio_carry: torch.Tensor               # (B, carry_0) raw samples
    carries: Tuple[torch.Tensor, ...]       # (B, carry_i, C_{i-1}), i=1..
    ring: torch.Tensor                      # (B, t_feat, C_last)
    hop: torch.Tensor                       # (B,) int32
    key: torch.Tensor                       # (B, 2) int64


class WindowState(NamedTuple):
    """Recompute-path state: the raw audio window only."""

    window: torch.Tensor                    # (B, window)
    hop: torch.Tensor                       # (B,) int32
    key: torch.Tensor                       # (B, 2) int64


def zeros_window_state(cfg: kws.KWSConfig, n: int, device) -> WindowState:
    return WindowState(
        window=torch.zeros((n, cfg.sample_len), device=device),
        hop=torch.zeros((n,), dtype=torch.int32, device=device),
        key=torch.zeros((n, 2), dtype=torch.int64, device=device))


def zeros_state(cfg: kws.KWSConfig, geom: StreamGeometry, n: int,
                device) -> StreamState:
    carries = tuple(
        torch.zeros((n, geom.layers[i].carry, cfg.channels[i - 1]),
                    device=device)
        for i in range(1, cfg.num_conv_layers))
    return StreamState(
        audio_carry=torch.zeros((n, geom.layers[0].carry), device=device),
        carries=carries,
        ring=torch.zeros((n, geom.t_feat, cfg.channels[-1]), device=device),
        hop=torch.zeros((n,), dtype=torch.int32, device=device),
        key=torch.zeros((n, 2), dtype=torch.int64, device=device))


def _tail(x: torch.Tensor, n: int) -> torch.Tensor:
    """Last ``n`` columns of axis 1 (empty when ``n`` is 0)."""
    return x[:, x.shape[1] - n:]


def _ring_logits(hwp: kws.HWParams, ring: torch.Tensor,
                 head_w: Optional[torch.Tensor],
                 head_b: Optional[torch.Tensor]) -> torch.Tensor:
    """GAP + FC, with an optional per-stream head: ``head_w`` (B, D, C) /
    ``head_b`` (B, C) replace the shared FC row by row.  Every product
    lies on a 2**-11 grid, so the batched product equals the shared one
    on rows that hold the base head."""
    if head_w is None:
        return kws.gap_fc(hwp, ring)[0]
    feats = ACT_Q.quantize(means.mean(ring, 1))
    return torch.bmm(feats[:, None, :], head_w)[:, 0] + head_b


def _merge_bias_delta(noise: Optional[torch.Tensor],
                      delta: Optional[torch.Tensor],
                      n_cols: int) -> Optional[torch.Tensor]:
    """Fold a per-stream bias delta (B, C) into the per-column pre-sign
    operand (B, n_cols, C) that the fused kernel adds where the word-line
    bias lands: ``noise + delta``, or the broadcast delta alone without
    SA noise (integers: bit-exact against refolding the bias)."""
    if delta is None:
        return noise
    d = delta[:, None, :]
    if noise is None:
        return d.expand(delta.shape[0], n_cols, delta.shape[1])
    return noise + d


def _keys_or_zeros(keys: Optional[torch.Tensor], b: int,
                   device) -> torch.Tensor:
    if keys is None:
        return torch.zeros((b, 2), dtype=torch.int64, device=device)
    return keys.to(device=device, dtype=torch.int64)


def stream_init(hw, window: torch.Tensor, cfg: kws.KWSConfig,
                geom: StreamGeometry, *,
                keys: Optional[torch.Tensor] = None,
                chip_offsets: Optional[Dict[str, torch.Tensor]] = None,
                sa_noise_std: float = 0.0,
                use_kernel: bool = True,
                bias_delta: Optional[Dict[str, torch.Tensor]] = None,
                head_w: Optional[torch.Tensor] = None,
                head_b: Optional[torch.Tensor] = None):
    """Process the streams' first full windows (B, window) and build their
    incremental state.  Equivalent to ``hw_forward`` on the window (window
    0 of each stream's noise field, ``keys`` (B, 2); zero keys if None),
    plus capturing each layer's ring tail.  ``bias_delta``/``head_w``/
    ``head_b`` are the per-stream customization riders.  Returns (logits
    (B, C), state)."""
    hwp, packed = kws.as_hw_params(hw)
    b = window.shape[0]
    keys = _keys_or_zeros(keys, b, window.device)
    noise_all = None
    if sa_noise_std > 0.0:                  # window 0 of every stream
        noise_all = field_window_noise(SANoiseField(
            keys, torch.zeros((b,), dtype=torch.int64, device=keys.device),
            sa_noise_std, geom.hop), cfg)
    h = window[..., None]
    carries = []
    for i in range(cfg.num_conv_layers):
        off = packed_i = noise = None
        if i > 0:
            lg = geom.layers[i]
            carries.append(_tail(h, lg.carry))
            if noise_all is not None:
                noise = noise_all[f"conv{i}"]
            if bias_delta is not None:
                noise = _merge_bias_delta(noise, bias_delta[f"conv{i}"],
                                          lg.t_conv)
            if chip_offsets is not None:
                off = chip_offsets[f"conv{i}"]
            packed_i = packed[f"conv{i}"] if packed else None
        h = kws.hw_conv_layer(hwp, i, h, cfg, packed=packed_i,
                              chip_offset=off, sa_noise=noise,
                              use_kernel=use_kernel)
    logits = _ring_logits(hwp, h, head_w, head_b)
    state = StreamState(
        audio_carry=_tail(window, geom.layers[0].carry),
        carries=tuple(carries), ring=h,
        hop=torch.ones((b,), dtype=torch.int32, device=window.device),
        key=keys)
    return logits, state


def _stream_advance(hw, state: StreamState, audio: torch.Tensor,
                    cfg: kws.KWSConfig, geom: StreamGeometry, n_hops: int, *,
                    chip_offsets, sa_noise_std, use_kernel, bias_delta=None,
                    head_w=None, head_b=None
                    ) -> Tuple[List[torch.Tensor], StreamState]:
    """Advance a batch of streams by ``n_hops`` consecutive hops with ONE
    fused-kernel launch per IMC layer: each layer's tail extends by the
    extra hops' fresh columns, and the noise field covers the extended
    tail.  Returns ([(B, C)] * n_hops logits, state)."""
    hwp, packed = kws.as_hw_params(hw)
    x = torch.cat([state.audio_carry, audio], dim=1)
    new_audio_carry = _tail(x, geom.layers[0].carry)
    h = kws.hw_conv_layer(hwp, 0, x[..., None], cfg)
    noise_all = None
    if sa_noise_std > 0.0:
        noise_all = hop_sa_noise_fields(state.key, state.hop, cfg, geom,
                                        sa_noise_std, n_hops=n_hops)
    new_carries = []
    for i in range(1, cfg.num_conv_layers):
        name = f"conv{i}"
        inp = torch.cat([state.carries[i - 1], h], dim=1)
        new_carries.append(_tail(inp, geom.layers[i].carry))
        off = chip_offsets[name] if chip_offsets is not None else None
        noise = noise_all[name] if noise_all is not None else None
        if bias_delta is not None:
            t_conv_tail = (inp.shape[1] - cfg.kernels[i]) // cfg.strides[i] + 1
            noise = _merge_bias_delta(noise, bias_delta[name], t_conv_tail)
        h = kws.hw_conv_layer(hwp, i, inp, cfg,
                              packed=packed[name] if packed else None,
                              chip_offset=off, sa_noise=noise,
                              use_kernel=use_kernel)
    logits_hops = []
    for j in range(1, n_hops + 1):
        ring = torch.cat([state.ring, h[:, :j * geom.d_feat]],
                         dim=1)[:, -geom.t_feat:]
        logits_hops.append(_ring_logits(hwp, ring, head_w, head_b))
    new_state = StreamState(audio_carry=new_audio_carry,
                            carries=tuple(new_carries), ring=ring,
                            hop=state.hop + n_hops, key=state.key)
    return logits_hops, new_state


def stream_step(hw, state: StreamState, audio: torch.Tensor,
                cfg: kws.KWSConfig, geom: StreamGeometry, *,
                chip_offsets: Optional[Dict[str, torch.Tensor]] = None,
                sa_noise_std: float = 0.0,
                use_kernel: bool = True,
                bias_delta: Optional[Dict[str, torch.Tensor]] = None,
                head_w: Optional[torch.Tensor] = None,
                head_b: Optional[torch.Tensor] = None):
    """Advance a batch of streams by one hop: audio (B, hop) -> (logits
    (B, C), new state).  Bit-identical to ``hw_forward`` on the matching
    full window.  ``bias_delta``/``head_w``/``head_b`` are the per-stream
    customization riders (see ``stream_init``)."""
    logits_hops, new_state = _stream_advance(
        hw, state, audio, cfg, geom, 1, chip_offsets=chip_offsets,
        sa_noise_std=sa_noise_std, use_kernel=use_kernel,
        bias_delta=bias_delta, head_w=head_w, head_b=head_b)
    return logits_hops[0], new_state


def stream_multi_step(hw, state: StreamState, audio: torch.Tensor,
                      cfg: kws.KWSConfig, geom: StreamGeometry,
                      n_hops: int, *,
                      chip_offsets: Optional[Dict[str, torch.Tensor]] = None,
                      sa_noise_std: float = 0.0,
                      use_kernel: bool = True,
                      bias_delta: Optional[Dict[str, torch.Tensor]] = None,
                      head_w: Optional[torch.Tensor] = None,
                      head_b: Optional[torch.Tensor] = None):
    """Advance by ``n_hops`` consecutive hops in ONE launch per IMC layer:
    audio (B, n_hops*hop) -> (logits (B, n_hops, C), new state).
    Bit-identical to ``n_hops`` sequential ``stream_step`` calls."""
    logits_hops, new_state = _stream_advance(
        hw, state, audio, cfg, geom, n_hops, chip_offsets=chip_offsets,
        sa_noise_std=sa_noise_std, use_kernel=use_kernel,
        bias_delta=bias_delta, head_w=head_w, head_b=head_b)
    return torch.stack(logits_hops, dim=1), new_state


# ---------------------------------------------------------------------------
# The recompute path: hw_forward over the whole window every hop
# ---------------------------------------------------------------------------


def _window_forward(hw, window: torch.Tensor, keys: torch.Tensor,
                    hops: torch.Tensor, cfg: kws.KWSConfig,
                    geom: StreamGeometry, *, chip_offsets, sa_noise_std,
                    use_kernel, bias_delta=None, head_w=None, head_b=None):
    """One ``hw_forward`` over B full windows (one fused-kernel launch per
    IMC layer): window ``hops`` of each stream's noise field, the bias
    deltas merged over every conv column, the per-stream head applied per
    row.  Returns (logits (B, C), the advanced ``WindowState``)."""
    noise = None
    if sa_noise_std > 0.0:
        noise = field_window_noise(SANoiseField(keys, hops, sa_noise_std,
                                                geom.hop), cfg)
    if bias_delta is not None:
        noise = dict(noise) if noise is not None else {}
        for i in range(1, cfg.num_conv_layers):
            name = f"conv{i}"
            noise[name] = _merge_bias_delta(noise.get(name),
                                            bias_delta[name],
                                            geom.layers[i].t_conv)
    logits, feats = kws.hw_forward(hw, window, cfg,
                                   chip_offsets=chip_offsets, sa_noise=noise,
                                   use_kernel=use_kernel,
                                   device=window.device)
    if head_w is not None:
        logits = torch.bmm(feats[:, None, :], head_w)[:, 0] + head_b
    return logits, WindowState(window=window, hop=hops + 1, key=keys)


def window_init(hw, window: torch.Tensor, cfg: kws.KWSConfig,
                geom: StreamGeometry, *, keys: Optional[torch.Tensor] = None,
                chip_offsets=None, sa_noise_std: float = 0.0,
                use_kernel: bool = True, bias_delta=None, head_w=None,
                head_b=None):
    """Recompute-path init: ``hw_forward`` on the first windows (B,
    window), window 0 of each stream's noise field."""
    b = window.shape[0]
    return _window_forward(
        hw, window, _keys_or_zeros(keys, b, window.device),
        torch.zeros((b,), dtype=torch.int32, device=window.device), cfg,
        geom, chip_offsets=chip_offsets, sa_noise_std=sa_noise_std,
        use_kernel=use_kernel, bias_delta=bias_delta, head_w=head_w,
        head_b=head_b)


def window_step(hw, state: WindowState, audio: torch.Tensor,
                cfg: kws.KWSConfig, geom: StreamGeometry, *,
                chip_offsets=None, sa_noise_std: float = 0.0,
                use_kernel: bool = True, bias_delta=None, head_w=None,
                head_b=None):
    """Recompute-path hop: slide each window by the hop's audio (B, hop)
    and rerun ``hw_forward`` on all of it.  Bit-identical to
    ``stream_step`` (same noise field), ~window/hop times the work."""
    window = torch.cat([state.window[:, geom.hop:], audio], dim=1)
    return _window_forward(hw, window, state.key, state.hop, cfg, geom,
                           chip_offsets=chip_offsets,
                           sa_noise_std=sa_noise_std, use_kernel=use_kernel,
                           bias_delta=bias_delta, head_w=head_w,
                           head_b=head_b)


def window_multi_step(hw, state: WindowState, audio: torch.Tensor,
                      cfg: kws.KWSConfig, geom: StreamGeometry,
                      n_hops: int, *, chip_offsets=None,
                      sa_noise_std: float = 0.0, use_kernel: bool = True,
                      bias_delta=None, head_w=None, head_b=None):
    """``n_hops`` sequential ``window_step`` calls over audio (B,
    n_hops*hop): n launches per IMC layer (the recompute path has no
    multi-hop tail to share).  Returns (logits (B, n_hops, C), state)."""
    logits = []
    for j in range(n_hops):
        lg, state = window_step(hw, state,
                                audio[:, j * geom.hop:(j + 1) * geom.hop],
                                cfg, geom, chip_offsets=chip_offsets,
                                sa_noise_std=sa_noise_std,
                                use_kernel=use_kernel, bias_delta=bias_delta,
                                head_w=head_w, head_b=head_b)
        logits.append(lg)
    return torch.stack(logits, dim=1), state


def gated_window_step(state: WindowState, geom: StreamGeometry
                      ) -> WindowState:
    """Recompute-path twin of ``gated_step``: slide each window by one hop
    of zeros (silence) without running ``hw_forward``."""
    b = state.hop.shape[0]
    window = torch.cat([state.window[:, geom.hop:],
                        state.window.new_zeros((b, geom.hop))], dim=1)
    return WindowState(window=window, hop=state.hop + 1, key=state.key)


# ---------------------------------------------------------------------------
# Voice-activity-gated no-op advance (no IMC launch)
# ---------------------------------------------------------------------------


def silence_fills(cfg: kws.KWSConfig, sil: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, ...]:
    """Order the per-layer silence columns (``kws.silence_columns``) into
    the tuple ``gated_step`` consumes: fills[i] is conv layer i's constant
    (C_i,) output column on silent audio."""
    return tuple(sil[f"conv{i}"] for i in range(cfg.num_conv_layers))


def retention_fills(hw, cfg: kws.KWSConfig, *, key: torch.Tensor,
                    sa_noise_std: float,
                    chip_offsets: Optional[Dict[str, torch.Tensor]] = None
                    ) -> Tuple[torch.Tensor, ...]:
    """SA-retention silence fills, the chip-accurate alternative to
    ``silence_fills``: a sleeping macro retains its last latched sense-
    amplifier read of the silent input, which carries one frozen SA-noise
    realization.  Each layer's fill is its silence response evaluated
    once with a noisy read (``sa_key = fold_in(key, layer)``), and that
    retained column feeds the next layer.  Deterministic in ``key`` (a
    ``jaxrand`` key on the parameters' device); at ``sa_noise_std=0``
    exactly ``silence_fills``."""
    hwp, _ = kws.as_hw_params(hw)
    h = torch.zeros((1, cfg.sample_len, 1), device=kws.hw_device(hwp))
    fills = []
    for i in range(cfg.num_conv_layers):
        off = sa_key = None
        if i > 0:
            if chip_offsets is not None:
                off = chip_offsets[f"conv{i}"]
            if sa_noise_std > 0.0:
                sa_key = jaxrand.fold_in(key, i)
        h = kws.hw_conv_layer(hwp, i, h, cfg, chip_offset=off,
                              sa_key=sa_key, sa_noise_std=sa_noise_std,
                              use_kernel=False)
        col = h[0, 0]
        fills.append(col)
        # the retained column is what downstream layers see while asleep
        h = col.expand(1, h.shape[1], col.shape[0])
    return tuple(fills)


def gated_step(state: StreamState, cfg: kws.KWSConfig, geom: StreamGeometry,
               fills: Tuple[torch.Tensor, ...]) -> StreamState:
    """Advance a batch of streams by one silent hop without computing:
    every carry and the GAP ring shift by their per-hop column counts,
    the shifted-in columns being each layer's silence response; the audio
    carry shifts in zeros.  Each ``fills`` entry is a shared (C_i,)
    column or a per-stream (B, C_i) one (customized streams carry
    compensated biases, so their silence response differs)."""
    b = state.hop.shape[0]

    def _fill(f, d):
        if f.dim() == 1:
            return f.expand(b, d, f.shape[-1])
        return f[:, None, :].expand(b, d, f.shape[-1])

    audio_carry = _tail(
        torch.cat([state.audio_carry,
                   state.audio_carry.new_zeros((b, geom.hop))], dim=1),
        geom.layers[0].carry)
    new_carries = []
    for i in range(1, cfg.num_conv_layers):
        lg = geom.layers[i]
        new_carries.append(_tail(
            torch.cat([state.carries[i - 1], _fill(fills[i - 1], lg.d_in)],
                      dim=1),
            lg.carry))
    ring = torch.cat([state.ring[:, geom.d_feat:],
                      _fill(fills[-1], geom.d_feat)], dim=1)
    return StreamState(audio_carry=audio_carry, carries=tuple(new_carries),
                       ring=ring, hop=state.hop + 1, key=state.key)


# ---------------------------------------------------------------------------
# Engine over a fixed batch of streams
# ---------------------------------------------------------------------------


class StreamEngine:
    """Init/step over a batch of streams on one device.  The scheduler
    (``serving.scheduler``) owns slots, masking and admission; this class
    owns the compute.  ``streaming=True`` runs the frame-incremental path
    over ``StreamState``; ``streaming=False`` the recompute path over
    ``WindowState`` (``hw_forward`` on the full window per hop).  ``hw``
    must already live on ``device``; ``chip_offsets`` are moved there."""

    def __init__(self, hw, cfg: kws.KWSConfig, hop: int, *,
                 chip_offsets: Optional[Dict[str, torch.Tensor]] = None,
                 sa_noise_std: float = 0.0, use_kernel: bool = True,
                 streaming: bool = True, device=None):
        self.device = resolve_device(device)
        if kws.hw_device(hw) != self.device:
            raise ValueError(f"StreamEngine: parameters are on "
                             f"{kws.hw_device(hw)}, not on {self.device}")
        self.cfg = cfg
        self.geom = make_stream_geometry(cfg, hop)
        self.hw = hw
        self.chip_offsets = None if chip_offsets is None else {
            k: kws.as_tensor(v, self.device) for k, v in chip_offsets.items()}
        self.sa_noise_std = float(sa_noise_std)
        self.use_kernel = use_kernel
        self.streaming = streaming

    def _kw(self, bias_delta, head_w, head_b) -> dict:
        return dict(chip_offsets=self.chip_offsets,
                    sa_noise_std=self.sa_noise_std,
                    use_kernel=self.use_kernel, bias_delta=bias_delta,
                    head_w=head_w, head_b=head_b)

    def zeros_state(self, n: int):
        if self.streaming:
            return zeros_state(self.cfg, self.geom, n, self.device)
        return zeros_window_state(self.cfg, n, self.device)

    def init(self, window: torch.Tensor, keys=None, bias_delta=None,
             head_w=None, head_b=None):
        """First full windows (B, window) of streams with noise-field
        ``keys`` (B, 2) -> (logits, state), with the optional per-stream
        customization riders."""
        fn = stream_init if self.streaming else window_init
        return fn(self.hw, window, self.cfg, self.geom, keys=keys,
                  **self._kw(bias_delta, head_w, head_b))

    def step(self, state, audio: torch.Tensor, bias_delta=None,
             head_w=None, head_b=None):
        """One hop (B, hop) -> (logits, state), with the optional riders:
        one fused-kernel launch per IMC layer for the whole batch."""
        fn = stream_step if self.streaming else window_step
        return fn(self.hw, state, audio, self.cfg, self.geom,
                  **self._kw(bias_delta, head_w, head_b))

    def multi_step(self, state, audio: torch.Tensor, n_hops: int,
                   bias_delta=None, head_w=None, head_b=None):
        """``n_hops`` hops (B, n_hops*hop) -> (logits (B, n_hops, C),
        state), with optional riders: one launch per IMC layer when
        streaming, ``n_hops`` on the recompute path."""
        fn = stream_multi_step if self.streaming else window_multi_step
        return fn(self.hw, state, audio, self.cfg, self.geom, n_hops,
                  **self._kw(bias_delta, head_w, head_b))


# ---------------------------------------------------------------------------
# Work accounting (feeds core.energy's streaming report)
# ---------------------------------------------------------------------------


def streaming_layer_stats(cfg: kws.KWSConfig, geom: StreamGeometry):
    """Per-decision op counts of the streaming path, in the schema of
    ``kws.layer_stats``: each conv layer touches only its tail columns."""
    out = []
    for i, s in enumerate(kws.layer_stats(cfg)):
        if i >= cfg.num_conv_layers:        # gap+fc row
            out.append(dict(s))
            continue
        lg = geom.layers[i]
        frac = (lg.t_conv - lg.conv_lo) / lg.t_conv
        cin = 1 if i == 0 else cfg.channels[i - 1]
        out.append({
            **s,
            "macs": int(round(s["macs"] * frac)),
            "in_bits": int(lg.tail_in * cin * (8 if i == 0 else 1)),
            "out_bits": int(lg.d_out * cfg.channels[i]),
            "cycles": int(round(s["cycles"] * frac)),
        })
    return out
