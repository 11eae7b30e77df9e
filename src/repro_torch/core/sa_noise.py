"""The per-absolute-column sense-amplifier noise field (hardware model).

Port of ``repro/core/sa_noise.py``.  The silicon evaluates every activation
column of every IMC layer through the sense amplifiers exactly once, so
the SA read noise of that evaluation belongs to the (stream, layer,
column) triple, not to the code path that computes it:

    noise(stream_key, layer, absolute_column)
        = std * normal(fold_in(fold_in(stream_key, layer), absolute_column))

Cached columns keep their realization across hops, a multi-hop batch
evaluates the same values as hop-by-hop stepping, and an offline window
forward reproduces the streaming path bit for bit by evaluating the same
field (``models.kws.hw_forward(sa_noise_field=...)``).  The keys are
``core.jaxrand`` keys, so the field is the JAX package's, value for value.

Where the reference ``vmap``s over columns and streams, this module hashes
a whole batch of (key, column) pairs at once.  ``cfg`` is duck-typed (any
object with ``num_conv_layers``, ``kernels``, ``strides``, ``pools``,
``channels`` and ``sample_len``).
"""

from __future__ import annotations

import functools
from typing import Dict, Mapping, NamedTuple

import torch

from repro_torch.core import jaxrand


class SANoiseField(NamedTuple):
    """A batch of window positions inside per-stream noise fields.

    keys: (N, 2) per-stream field keys (``jaxrand`` keys; the server
          derives them as ``fold_in(base_key, stream_uid)``);
    hops: (N,) window indices: window ``t`` of a stream occupies samples
          ``[t*hop, t*hop + window)`` and its layer-l conv columns sit at
          absolute indices ``t*n_new_l + local``;
    std:  the SA read-noise sigma (in counts);
    hop:  the stream hop in samples (a multiple of
          ``serving.stream.hop_alignment(cfg)``)."""

    keys: torch.Tensor
    hops: torch.Tensor
    std: float
    hop: int


def sa_noise_columns(key: torch.Tensor, layer: int, cols: torch.Tensor,
                     c_out: int, std: float) -> torch.Tensor:
    """Field values of streams ``key`` (..., 2) at absolute conv columns
    ``cols`` (..., n_cols), the key's batch leading: (..., n_cols, c_out).
    Column ``a`` of layer ``l`` always yields the same realization for
    the same stream key."""
    base = jaxrand.fold_in(key, layer)
    col_keys = jaxrand.fold_in(base[..., None, :], cols)
    return std * jaxrand.normal(col_keys, (c_out,))


@functools.lru_cache(maxsize=None)
def _layer_ids(layers: tuple, device: torch.device) -> torch.Tensor:
    """The layer indices as an int64 tensor on ``device``, made once and
    by fills on the device, not by a copy from the host: a hop's noise
    evaluation syncs with nothing, so it can be captured in a CUDA graph
    (``serving.compiled``)."""
    ids = torch.zeros((len(layers),), dtype=torch.int64, device=device)
    for i, layer in enumerate(layers):
        ids[i].fill_(layer)
    return ids


def columns_noise(keys: torch.Tensor, cols: Mapping[int, torch.Tensor],
                  channels, std: float) -> Dict[int, torch.Tensor]:
    """Field values of several layers at once: streams ``keys`` (B, 2),
    ``cols`` {layer: (B, n_layer) absolute conv columns} ->
    {layer: (B, n_layer, channels[layer])}.  The same values as
    ``sa_noise_columns`` per layer, from one hash of every (stream,
    column) pair and one hash of every (stream, column, channel) triple,
    so a hop pays three hashes whatever the number of layers (the
    reference's cross-layer hoist, ``hop_sa_noise_fields``)."""
    layers = list(cols)
    b = keys.shape[0]
    dev = keys.device
    base = jaxrand.fold_in(keys[:, None, :],
                           _layer_ids(tuple(layers), dev))   # (B, L, 2)
    widths = [cols[layer].shape[1] for layer in layers]
    base_cols = torch.cat([base[:, j:j + 1].expand(b, n, 2)
                           for j, n in enumerate(widths)], dim=1)
    col_keys = jaxrand.fold_in(base_cols, torch.cat(
        [cols[layer] for layer in layers], dim=1))         # (B, S, 2)
    flat_keys, flat_idx, off = [], [], 0
    for layer, n in zip(layers, widths):
        c = channels[layer]
        flat_keys.append(col_keys[:, off:off + n, None].expand(
            b, n, c, 2).reshape(-1, 2))
        flat_idx.append(torch.arange(c, dtype=torch.int64, device=dev)
                        .expand(b, n, c).reshape(-1))
        off += n
    vals = std * jaxrand.normal_from_bits(jaxrand.bits_at(
        torch.cat(flat_keys), torch.cat(flat_idx)))
    out, off = {}, 0
    for layer, n in zip(layers, widths):
        size = b * n * channels[layer]
        out[layer] = vals[off:off + size].reshape(b, n, channels[layer])
        off += size
    return out


def layer_window_cols(cfg, hop: int) -> Dict[str, tuple]:
    """Per conv layer: ``(t_conv, n_new)``, the full-window conv length and
    the fresh conv columns one hop contributes (the serving geometry's
    stride/pool recurrence)."""
    t_in, d_in = cfg.sample_len, hop
    out = {}
    for i in range(cfg.num_conv_layers):
        k, s, p = cfg.kernels[i], cfg.strides[i], cfg.pools[i]
        t_conv = (t_in - k) // s + 1
        n_new = d_in // s
        out[f"conv{i}"] = (t_conv, n_new)
        t_in, d_in = t_conv // p, n_new // p
    return out


def field_window_noise(field: SANoiseField, cfg) -> Dict[str, torch.Tensor]:
    """Expand a field batch to full-window per-layer realizations,
    {conv_i: (N, t_conv_i, C_i)} (the ``hw_forward(sa_noise=...)``
    layout), on the device of ``field.keys``.  Row ``n`` evaluates stream
    ``keys[n]``'s field at window ``hops[n]``: the values the streaming
    path cached for those columns."""
    keys = field.keys
    hops = torch.as_tensor(field.hops, dtype=torch.int64,
                           device=keys.device)
    out = {}
    for i, (name, (t_conv, n_new)) in enumerate(
            layer_window_cols(cfg, field.hop).items()):
        if i == 0:
            continue
        cols = hops[:, None] * n_new + torch.arange(
            t_conv, dtype=torch.int64, device=keys.device)
        # one layer per hash: full windows are large, and this bounds the
        # temporaries to one layer's
        out[name] = columns_noise(keys, {i: cols}, cfg.channels,
                                  field.std)[i]
    return out
