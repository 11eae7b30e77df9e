"""The encoder-decoder's gap to the reference over seeded inputs, and where
it comes from (the figures behind ``tests/test_torch_encdec.py``'s
tolerances), on the CPU, on the reduced seamless-m4t-medium of that file:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_encdec_sweep.py \\
        [--seeds 32] [--ops 32] [--rope]

* the sweep (``--seeds``): frames ``default_rng(seed)``'s draws 0-2 of
  (2, 8, 128) normals, the test's tokens; per input the port's ``encode``
  against the reference's jitted one (``mem``, and the share of its
  elements off), 8 teacher-forced decode steps of the whole model
  (``whole``: each package on its own memory), of the port's decoder fed
  the reference's memory (``on_ref``), and what the memory's flips move
  (``mem_effect``: the port's decoder on its own memory against itself on
  the reference's), each the largest gap in bfloat16 ulps of the
  reference tensor's largest magnitude, as the test's ``within_ulps``;
* the op check (``--ops`` seeds of the same inputs): every op of the
  port's encoder and decoder fed the reference's exact inputs, taken from
  the reference's own jitted ``lax.scan`` with each layer's pieces as
  scan outputs (its logits stay bitwise the whole-model jit's: checked),
  and the elements where its output parts from the reference's;
* ``--rope``: the RoPE pieces alone: XLA's ``cos`` / ``sin`` against the
  C library's ``cosf`` / ``sinf`` and against the correctly rounded
  values, and the rotation on 4.2 M bfloat16 inputs against the port's.

Prints JSON lines; imports both packages (a test helper, not part of the
port).
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import argparse
import ctypes
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import get_config as jget
from repro.launch import steps as jsteps
from repro.models import encdec as JED
from repro.models import layers as JL
from repro_torch.configs.base import get_config
from repro_torch.launch import steps
from repro_torch.models import encdec as ED
from repro_torch.models import layers as L
from repro_torch.models import lm as LM

ARCH = "seamless-m4t-medium"
B, S = 2, 8
BF = jnp.bfloat16


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def gap(got, want, ref=None) -> float:
    """Largest |got - want| in bfloat16 ulps of ``ref``'s (default
    ``want``'s) largest magnitude."""
    g, w = f32(got), f32(want)
    r = w if ref is None else f32(ref)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(r).max())) - 7)
    return float(np.abs(g - w).max() / ulp)


def frames_for(seed, draw, d=128, s_enc=8):
    rng = np.random.default_rng(seed)
    for _ in range(draw + 1):
        f = rng.standard_normal((B, s_enc, d)).astype(np.float32)
    return f


class Setup:
    """Both packages' reduced configs, the reference's eager draw carried
    to the port, the test's tokens and the reference's jitted encode and
    decode step."""

    def __init__(self):
        self.cfg, self.jcfg = get_config(ARCH).reduced(), jget(ARCH).reduced()
        tree = jax.tree_util.tree_map(
            np.asarray, JED.init_encdec(jax.random.PRNGKey(0), self.jcfg))
        self.jp = jax.tree_util.tree_map(jnp.asarray, tree)
        self.params = ED.params_from_numpy(tree, self.cfg, device="cpu")
        self.tokens = np.random.default_rng(2).integers(
            2, self.cfg.vocab_size, (B, S)).astype(np.int32)
        jcfg = self.jcfg
        self.jenc = jax.jit(lambda p, f: JED.encode(p, jcfg, f, train=False))
        self.dstep = jax.jit(jsteps.make_decode_step(jcfg))
        self.decode = steps.make_decode_step(self.cfg)

    def ref_decode(self, memory):
        cache, out = JED.init_dec_cache(self.jcfg, B, S), []
        for t in range(S):
            logits, cache = self.dstep(self.jp, cache, self.batch(t, memory))
            out.append(logits)
        return out

    def batch(self, t, memory):
        return {"tokens": self.tokens[:, t:t + 1], "memory": memory,
                "index": jnp.int32(t)}

    def port_decode(self, memory):
        cache = ED.init_dec_cache(self.cfg, B, S, device="cpu")
        out = []
        for t in range(S):
            logits, cache = self.decode(self.params, cache, {
                "tokens": self.tokens[:, t:t + 1], "memory": memory,
                "index": t})
            out.append(logits)
        return out


def sweep(su: Setup, seeds: int):
    rows = []
    for seed in range(seeds):
        for draw in range(3):
            fr = frames_for(seed, draw)
            jmem = su.jenc(su.jp, jnp.asarray(fr, BF))
            pmem = ED.encode(su.params, su.cfg, torch.tensor(fr), train=False)
            jout = su.ref_decode(jmem)
            own = su.port_decode(pmem)
            on_ref = su.port_decode(torch.tensor(f32(jmem)).bfloat16())
            row = dict(
                seed=seed, draw=draw, mem=gap(pmem, jmem),
                mem_share=float(np.mean(f32(pmem) != f32(jmem))),
                whole=max(gap(a, b) for a, b in zip(own, jout)),
                on_ref=max(gap(a, b) for a, b in zip(on_ref, jout)),
                mem_effect=max(gap(a, b, w)
                               for a, b, w in zip(own, on_ref, jout)))
            rows.append(row)
            print(json.dumps(row), flush=True)
    summary = {k: max(r[k] for r in rows)
               for k in ("mem", "mem_share", "whole", "on_ref",
                         "mem_effect")}
    summary.update(inputs=len(rows),
                   mem_differs=sum(r["mem"] > 0 for r in rows),
                   whole_minus_on_ref=max(r["whole"] - r["on_ref"]
                                          for r in rows))
    print(json.dumps({"sweep": summary}), flush=True)


# ---------------------------------------------------------------------------
# the op check
# ---------------------------------------------------------------------------


def _attn_pieces(p, acfg, x, cache=None, cache_index=None, kv_override=None):
    """``layers.attention``'s steps, each kept (the reference's code)."""
    b, s, _ = x.shape
    o = {"x": x}
    pos = jnp.arange(s)[None, :] + (0 if cache_index is None else cache_index)
    src = x if kv_override is None else kv_override
    sk = src.shape[1]
    q = JL.dense(p["wq"], x).reshape(b, s, acfg.n_heads, acfg.head_dim)
    k = JL.dense(p["wk"], src).reshape(b, sk, acfg.n_kv_heads, acfg.head_dim)
    v = JL.dense(p["wv"], src).reshape(b, sk, acfg.n_kv_heads, acfg.head_dim)
    o["q_lin"], o["k_lin"], o["v"] = q, k, v
    if kv_override is None:
        q = JL.apply_rope(q, pos, acfg.rope_theta)
        k = JL.apply_rope(k, pos if cache_index is not None
                          else jnp.arange(sk)[None, :], acfg.rope_theta)
    o["q"] = q
    if cache is not None:
        k = jax.lax.dynamic_update_slice_in_dim(
            cache["k"], k.astype(cache["k"].dtype), cache_index, axis=1)
        v = jax.lax.dynamic_update_slice_in_dim(
            cache["v"], v.astype(cache["v"].dtype), cache_index, axis=1)
        sk = k.shape[1]
    o["k"], o["vc"] = k, v
    logits = (jnp.einsum("bqhd,bkhd->bhqk", q, k)
              * acfg.head_dim ** -0.5).astype(jnp.float32)
    if cache is not None:
        valid = jnp.arange(sk)[None, None, None, :] <= (
            cache_index + jnp.arange(s)[None, None, :, None])
        logits = jnp.where(valid, logits, -1e30)
    o["logits"] = logits
    w = jax.nn.softmax(logits, axis=-1).astype(q.dtype)
    o["w"] = w
    out = jnp.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, s, -1)
    o["pre_wo"], o["out"] = out, JL.dense(p["wo"], out)
    return o


def _mlp_pieces(p, x):
    up = JL.dense(p["w_up"], x)
    g = jax.nn.gelu(up)
    return {"mx": x, "up": up, "gelu": g, "mlp": JL.dense(p["w_down"], g)}


def _ref_fns(su: Setup):
    jcfg = su.jcfg
    acfg = jcfg.attn_cfg()
    acfg_bi = JL.AttnConfig(**{**acfg.__dict__, "causal": False})

    @jax.jit
    def enc(jp, frames):
        def body(hh, lp):
            o = {"h0": hh}
            x1 = JL.rmsnorm(lp["ln1"], hh)
            o["ln1"] = x1
            o.update({"a." + k: v for k, v in
                      _attn_pieces(lp["attn"], acfg_bi, x1).items()})
            a, _ = JL.attention(lp["attn"], acfg_bi, x1)
            o["attn"] = a
            hh = hh + a
            x2 = JL.rmsnorm(lp["ln2"], hh)
            o["ln2"] = x2
            o.update(_mlp_pieces(lp["mlp"], x2))
            return hh + JL.mlp(lp["mlp"], x2, JL.NO_SHARDING,
                               jcfg.gated_mlp), o
        h, ys = jax.lax.scan(body, frames.astype(BF), jp["encoder"])
        return ys, h, JL.rmsnorm(jp["ln_enc"], h)

    @jax.jit
    def dec(jp, cache, tok, memory, index):
        def body(hh, xs):
            lp, lc = xs
            o = {"h0": hh}
            x1 = JL.rmsnorm(lp["ln1"], hh)
            o["ln1"] = x1
            o.update({"s." + k: v for k, v in _attn_pieces(
                lp["self_attn"], acfg, x1, cache=lc,
                cache_index=index).items()})
            a, nc = JL.attention(lp["self_attn"], acfg, x1, cache=lc,
                                 cache_index=index)
            o["self"] = a
            hh = hh + a
            x2 = JL.rmsnorm(lp["ln_x"], hh)
            o["lnx"] = x2
            o.update({"c." + k: v for k, v in _attn_pieces(
                lp["cross_attn"], acfg, x2, kv_override=memory).items()})
            x, _ = JL.attention(lp["cross_attn"], acfg, x2,
                                kv_override=memory)
            o["cross"] = x
            hh = hh + x
            x3 = JL.rmsnorm(lp["ln2"], hh)
            o["ln2"] = x3
            o.update(_mlp_pieces(lp["mlp"], x3))
            return hh + JL.mlp(lp["mlp"], x3, JL.NO_SHARDING,
                               jcfg.gated_mlp), (nc, o)
        h, (_, ys) = jax.lax.scan(body, jp["embed"].astype(BF)[tok],
                                  (jp["decoder"], cache))
        hf = JL.rmsnorm(jp["ln_f"], h)
        return ys, h, hf, hf @ jp["unembed"].astype(BF)

    return enc, dec


def _t(x, dtype=torch.bfloat16):
    return torch.tensor(f32(x)).to(dtype)


class Counts(dict):
    def add(self, name, got, want):
        g = f32(got) if isinstance(got, torch.Tensor) else got
        w = f32(want) if not isinstance(want, np.ndarray) else want
        c = self.setdefault(name, [0, 0])
        c[0] += int((g != w).sum())
        c[1] += int(g.size)


def _attn_ops(lp, acfg, o, pre, rope, counts, tag, memory=None):
    x = _t(o[pre + "x"])
    b, s = x.shape[:2]
    src = x if memory is None else _t(memory)
    sk = src.shape[1]
    with L.float32_accumulation():
        q = L.dense(lp["wq"], x).reshape(b, s, acfg.n_heads, acfg.head_dim)
        k = L.dense(lp["wk"], src).reshape(b, sk, acfg.n_kv_heads,
                                           acfg.head_dim)
        v = L.dense(lp["wv"], src).reshape(b, sk, acfg.n_kv_heads,
                                           acfg.head_dim)
    counts.add(tag + "q product", q, o[pre + "q_lin"])
    counts.add(tag + "k product", k, o[pre + "k_lin"])
    counts.add(tag + "v product", v, o[pre + "v"])
    if rope is not None:
        counts.add(tag + "rope", L._rotate(_t(o[pre + "q_lin"]), rope),
                   o[pre + "q"])
    scale = float(torch.tensor(acfg.head_dim ** -0.5, dtype=torch.bfloat16))
    with L.float32_accumulation():
        logits = torch.einsum("bqhd,bkhd->bhqk", _t(o[pre + "q"]),
                              _t(o[pre + "k"])).float() * scale
    ref = _t(o[pre + "logits"], torch.float32)
    valid = ref > -1e29
    counts.add(tag + "qk product", logits[valid], ref[valid].numpy())
    lg = ref.masked_fill(~valid, L.MASK_VALUE)
    e = torch.exp(lg - torch.amax(lg, dim=-1, keepdim=True))
    counts.add(tag + "softmax",
               (e / torch.sum(e, dim=-1, keepdim=True)).bfloat16(),
               o[pre + "w"])
    with L.float32_accumulation():
        pre_wo = torch.einsum("bhqk,bkhd->bqhd", _t(o[pre + "w"]),
                              _t(o[pre + "vc"])).reshape(b, s, -1)
        out = L.dense(lp["wo"], _t(o[pre + "pre_wo"]))
    counts.add(tag + "wv product", pre_wo, o[pre + "pre_wo"])
    counts.add(tag + "wo product", out, o[pre + "out"])


def _mlp_ops(lp, o, counts):
    with L.float32_accumulation():
        counts.add("up product", L.dense(lp["mlp"]["w_up"], _t(o["mx"])),
                   o["up"])
        counts.add("down product",
                   L.dense(lp["mlp"]["w_down"], _t(o["gelu"])), o["mlp"])
    counts.add("gelu", L.gelu_tanh(_t(o["up"])), o["gelu"])


def _norm(counts, name, p, ref_out, *parts):
    """The port's norm on the reference's float32 residual sum (XLA keeps
    the bfloat16 sum in float32 where the norm reads it)."""
    mid = _t(parts[0]).float()
    for part in parts[1:]:
        mid = mid.bfloat16().float() + _t(part).float()
    counts.add(name, L.rmsnorm(p, mid).bfloat16(), ref_out)


def op_check(su: Setup, seeds: int):
    enc_fn, dec_fn = _ref_fns(su)
    cfg, jp = su.cfg, su.jp
    acfg = cfg.attn_cfg()
    acfg_bi = dataclasses.replace(acfg, causal=False)
    enc, dec = Counts(), Counts()
    same = True
    rope = L.rope_tables(torch.arange(cfg.frontend_len), cfg.head_dim,
                         cfg.rope_theta)
    for seed in range(seeds):
        for draw in range(3):
            fr = jnp.asarray(frames_for(seed, draw), BF)
            ys, h, mem = enc_fn(jp, fr)
            same &= bool(np.array_equal(f32(mem), f32(su.jenc(jp, fr))))
            for i in range(cfg.n_encoder_layers):
                o = {k: v[i] for k, v in ys.items()}
                lp = LM.layer(su.params["encoder"], i)
                _norm(enc, "rmsnorm", lp["ln1"], o["ln1"], o["h0"])
                _attn_ops(lp["attn"], acfg_bi, o, "a.", rope, enc, "")
                _norm(enc, "rmsnorm", lp["ln2"], o["ln2"], o["h0"],
                      o["attn"])
                _mlp_ops(lp, o, enc)
            enc.add("rmsnorm", L.rmsnorm(su.params["ln_enc"], _t(h)), mem)
            cache = JED.init_dec_cache(su.jcfg, B, S)
            for t in range(S):
                ys, hl, hf, logits = dec_fn(jp, cache, su.tokens[:, t:t + 1],
                                            mem, jnp.int32(t))
                whole, cache = su.dstep(jp, cache, su.batch(t, mem))
                same &= bool(np.array_equal(f32(logits), f32(whole)))
                rope_t = L.rope_tables(torch.arange(1)[None, :] + t,
                                       cfg.head_dim, cfg.rope_theta)
                for i in range(cfg.n_layers):
                    o = {k: v[i] for k, v in ys.items()}
                    lp = LM.layer(su.params["decoder"], i)
                    _norm(dec, "rmsnorm", lp["ln1"], o["ln1"], o["h0"])
                    _attn_ops(lp["self_attn"], acfg, o, "s.", rope_t, dec,
                              "self ")
                    _norm(dec, "rmsnorm", lp["ln_x"], o["lnx"], o["h0"],
                          o["self"])
                    _attn_ops(lp["cross_attn"], acfg, o, "c.", None, dec,
                              "cross ", memory=mem)
                    _norm(dec, "rmsnorm", lp["ln2"], o["ln2"], o["h0"],
                          o["self"], o["cross"])
                    _mlp_ops(lp, o, dec)
                dec.add("rmsnorm", L.rmsnorm(su.params["ln_f"], _t(hl)), hf)
                with L.float32_accumulation():
                    dec.add("unembed product",
                            _t(hf) @ su.params["unembed"].bfloat16(), logits)
    print(json.dumps({"op_check": {
        "inputs": 3 * seeds, "instrumented_equals_whole_jit": same,
        "encoder": enc, "decoder_on_reference_memory": dec}}), flush=True)


def rope_check():
    """XLA's sin / cos against the C library's and the correctly rounded
    values; the rotation against the port's."""
    libm = ctypes.CDLL("libm.so.6")
    for fn in ("cosf", "sinf"):
        getattr(libm, fn).restype = ctypes.c_float
        getattr(libm, fn).argtypes = [ctypes.c_float]
    ang = np.random.default_rng(0).uniform(-100, 100, 40000).astype(
        np.float32)
    out = {}
    for name, jfn, cfn, nfn in (("cos", jnp.cos, libm.cosf, np.cos),
                                ("sin", jnp.sin, libm.sinf, np.sin)):
        x = np.asarray(jax.jit(jfn)(jnp.asarray(ang)))
        c = np.array([cfn(float(a)) for a in ang], np.float32)
        r = nfn(ang.astype(np.float64)).astype(np.float32)
        out[name] = dict(xla_vs_libm=int((x != c).sum()),
                         xla_vs_rounded=int((x != r).sum()), of=ang.size)
    hd, s = 32, 256
    x = jnp.asarray(np.random.default_rng(0).standard_normal(
        (128, s, 4, hd)).astype(np.float32), BF)
    ref = f32(jax.jit(lambda x: JL.apply_rope(
        x, jnp.arange(s)[None, :], 1e4))(x))
    got = f32(L.apply_rope(_t(x), torch.arange(s), 1e4))
    # the port's former forms: the quotient of the rounded power, torch's
    # float32 cos / sin, two roundings in the rotation
    exps = torch.arange(0, hd, 2, dtype=torch.float32) / hd
    old_freqs = 1.0 / torch.pow(1e4, exps)
    ang = torch.arange(s).float()[None, :, None] * old_freqs
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(_t(x).float(), 2, dim=-1)
    old = f32(torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                        dim=-1).bfloat16())
    out["apply_rope_positions_0_255"] = dict(
        differ=int((got != ref).sum()), former=int((old != ref).sum()),
        of=ref.size)
    freqs = np.asarray(jax.jit(lambda: JL.rope_freqs(hd, 1e4))())
    out["freqs"] = dict(
        differ=int((L.rope_freqs(hd, 1e4).numpy() != freqs).sum()),
        former=int((old_freqs.numpy() != freqs).sum()), of=freqs.size)
    print(json.dumps({"rope": out}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=32)
    ap.add_argument("--ops", type=int, default=0)
    ap.add_argument("--rope", action="store_true")
    args = ap.parse_args()
    su = Setup()
    if args.seeds:
        sweep(su, args.seeds)
    if args.ops:
        op_check(su, args.ops)
    if args.rope:
        rope_check()


if __name__ == "__main__":
    main()
