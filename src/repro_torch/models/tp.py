"""The decoders' serving steps over a ``(data, model)`` mesh, run in one
process over the mesh's positions.

``prefill`` and ``decode_step`` take a param tree placed over the mesh
(``parallel.sharding.shard_tree`` under ``steps/serve.serve_shardings``)
and run each layer at every position in turn, on that position's blocks;
what GSPMD inserts between the reference's sharded operands is here an
explicit collective of ``parallel.collectives``:

* the batch runs over the data axes (where it splits evenly: a batch
  smaller than them is whole at every position);
* attention: ``wq``/``wk``/``wv`` (and their biases) are column blocks,
  ``wo`` a row block whose partial outputs are summed over ``model``.  A
  projection whose block falls on head boundaries keeps its heads local,
  and under GQA query-head block p reads KV-head block p; one whose block
  cuts a head (hymba-1.5b's 25 heads over 4 positions, 2 KV heads over 4)
  is gathered over ``model``, the position attends whole heads and slices
  its ``wo`` rows out of the output;
* the MLP: column-split gate/up (in), row-split down (out), summed;
* MoE: the experts over ``model`` where their count divides it, else the
  FFN dims (the reference's ``_MOE_FALLBACK``); the partial combines are
  summed.  The global dispatch takes its capacity from every token of the
  batch, so its inputs are gathered over the data axes first; under
  ``moe_row_dispatch`` each row dispatches where it lies;
* mamba: each position holds its channel range of both halves of
  ``in_proj`` (``sharding.HALVED``) and of the conv, dt and A params, so
  the conv, the scan (``ssm_scan`` on d_inner / model channels) and the
  gate run on its channels; ``x_proj``'s partials are summed and the
  gated output gathered before the replicated ``out_proj``;
* the embedding's vocab rows and the head's vocab columns are split over
  ``model``: a token outside a position's rows adds zeros to the sum, and
  the logits are gathered;
* a weight whose spec names a data axis (the train-mode rules, i.e.
  ``serve_tp_only`` off) is gathered over it at its use and dropped.

The cache is a dict of ``Sharded`` leaves and ``pos``: ``k``/``v`` with the
batch over the data axes and the heads as the K/V projections leave them,
or, under ``decode_shard_map`` (``seq_shard``), the sequence over
``model`` (over the data axes and ``model`` jointly for a batch smaller
than the data axes) with every head; ``ssm``/``conv`` channels over
``model``.  A decode step over a sequence-split cache gathers the query
heads over ``model`` and reads each shard at its own position with its
log-sum-exp (``flash_decode_sharded``, the combine formed on the group's
first position).  The steps return whole logits on the first position's
device.

Kernels run at each position on its blocks: ``flash_attention`` on its
heads, ``flash_decode`` on its heads or its sequence shard, ``ssm_scan``
on its channels, ``rmsnorm`` on the (replicated) hidden state.  On a mesh
of meta devices nothing is computed and every position's kernel calls
reach the cost mode (``roofline.op_cost``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import perf_flags
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.embedder import layer_params
from repro_torch.models.lm import _mix, add_positions, cache_len
from repro_torch.parallel import collectives as C
from repro_torch.parallel import sharding

Params = Dict[str, Any]
MODEL = ("model",)


def _flat(tree, path=()) -> Dict[Tuple[str, ...], Any]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {path: tree}


def _unflat(items: Dict[Tuple[str, ...], Any]) -> Params:
    out: Params = {}
    for path, v in items.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def _entry(e) -> Tuple[str, ...]:
    return () if e is None else (e if isinstance(e, tuple) else (e,))


def _heads_for(h0: int, h1: int, G: int):
    """The KV heads that query heads [h0, h1) read under groups of G: (lo,
    hi, index) -- index None when head h0 + j reads kv head lo + j // ((h1
    - h0) / (hi - lo)), as the kernels' GQA maps them, else the kv head of
    each query head."""
    lo, hi = h0 // G, (h1 - 1) // G + 1
    if hi - lo == 1 or (h0 % G == 0 and (h1 - h0) % G == 0):
        return lo, hi, None
    return lo, hi, [h // G - lo for h in range(h0, h1)]


def _pick(t: torch.Tensor, lo: int, hi: int, index) -> torch.Tensor:
    """t's heads (dim 2) [lo, hi), or the heads of ``index`` among them."""
    t = t[:, :, lo:hi]
    if index is None:
        return t
    return t[:, :, torch.tensor(index, device=t.device)]


class Run:
    """One step over the positions of a mesh: each position's blocks, its
    coordinates and rows, and the collectives over its axes.  A value that
    differs by position is a list, one entry a position in mesh order."""

    def __init__(self, cfg: ModelConfig, mesh, params: Params, batch: int):
        self.cfg, self.mesh = cfg, mesh
        self.n, self.devices = mesh.size, mesh.device_list
        self.M = mesh.shape.get("model", 1)
        self.model = MODEL if "model" in mesh.shape else ()
        self.dp = sharding.dp_axes(mesh)
        dn = sharding._dp_size(mesh)
        self.mi = [C.axis_index(mesh, p, self.model) for p in range(self.n)]
        self.di = [C.axis_index(mesh, p, self.dp) for p in range(self.n)]
        # the batch over the data axes where it splits evenly (batch_pspecs)
        self.b_split = dn > 1 and batch >= dn and batch % dn == 0
        self.b = batch // dn if self.b_split else batch
        self.b_spec = ((self.dp if len(self.dp) > 1 else self.dp[0])
                       if self.b_split else None)
        flat = _flat(params)
        self.specs = {k: s.spec for k, s in flat.items()}
        self.local = [_unflat({k: s.blocks[p] for k, s in flat.items()})
                      for p in range(self.n)]
        H, KV = cfg.num_heads, cfg.num_kv_heads
        self.q_split = self.split(("blocks", "attn", "wq"), -1)
        self.kv_split = self.split(("blocks", "attn", "wk"), -1)
        self.q_heads = self.q_split and H % self.M == 0
        self.kv_heads = self.kv_split and KV % self.M == 0

    # -- layout -------------------------------------------------------------
    def split(self, path, dim: int) -> bool:
        """Whether leaf ``path``'s dim ``dim`` is split over ``model``."""
        spec = self.specs.get(path)
        return spec is not None and len(spec) > 0 and "model" in _entry(
            spec[dim] if dim < len(spec) else None)

    def rows(self, p: int) -> slice:
        """The batch rows position p holds."""
        if not self.b_split:
            return slice(None)
        return slice(self.di[p] * self.b, (self.di[p] + 1) * self.b)

    def split_rows(self, t: torch.Tensor) -> List[torch.Tensor]:
        return [t[self.rows(p)].to(self.devices[p]) for p in range(self.n)]

    def _gather_data(self, trees: List[Params], prefix: Tuple[str, ...],
                     lead: int) -> List[Params]:
        """Each leaf of ``trees`` (one a position) with the dims its spec
        splits over data axes gathered (``lead`` leading spec entries, a
        layer dim indexed away, skipped)."""
        flats = [_flat(t) for t in trees]
        for path in flats[0]:
            spec = self.specs[prefix + path][lead:]
            for dim, e in enumerate(spec):
                axes = _entry(e)
                if axes and set(axes) <= set(self.dp):
                    got = C.all_gather([f[path] for f in flats], self.mesh,
                                       axes, dim)
                    for f, g in zip(flats, got):
                        f[path] = g
        return [_unflat(f) for f in flats]

    def top(self, name: str) -> List[Any]:
        """A top-level leaf (or subtree) at every position, gathered."""
        return [t[name] for t in self._gather_data(
            [{name: loc[name]} for loc in self.local], (), 0)]

    def layer(self, i: int) -> List[Params]:
        """Layer i's params at every position, gathered."""
        return self._gather_data(
            [layer_params(loc["blocks"], i) for loc in self.local],
            ("blocks",), 1)

    def sum_model(self, xs):
        return C.all_reduce_sum(xs, self.mesh, self.model)

    def gather_model(self, xs, dim: int):
        return C.all_gather(xs, self.mesh, self.model, dim)

    # -- embedding and head -------------------------------------------------
    def embed(self, toks, pos_offset: int, cdt, extra=None):
        """Token embeddings at every position (h list, positions list)."""
        emb = self.top("embed")
        vsplit = self.split(("embed",), 0)
        hs = []
        for p in range(self.n):
            t = toks[p].long()
            if vsplit:
                n = emb[p].shape[0]
                t = t - self.mi[p] * n
                inside = (t >= 0) & (t < n)
                e = emb[p][t.clamp(0, n - 1)].to(cdt)
                hs.append(e.masked_fill(~inside[..., None], 0))
            else:
                hs.append(emb[p][t].to(cdt))
        if vsplit:
            hs = self.sum_model(hs)
        out = [add_positions(self.cfg, h, pos_offset,
                             None if extra is None else extra[p])
               for p, h in enumerate(hs)]
        return [o[0] for o in out], [o[1] for o in out]

    def unembed(self, hs) -> torch.Tensor:
        """The whole logits (B, S, V) of hs on the first position's
        device."""
        cfg = self.cfg
        norm = self.top("final_norm")
        if cfg.tie_embeddings:
            heads = [e.T for e in self.top("embed")]
            vsplit = self.split(("embed",), 0)
        else:
            heads = self.top("lm_head")
            vsplit = self.split(("lm_head",), -1)
        out = []
        for p, h in enumerate(hs):
            x = L.apply_norm(norm[p], cfg, h)
            out.append(x @ heads[p].to(x.dtype))
        if vsplit:
            out = self.gather_model(out, -1)
        if self.b_split:
            out = C.all_gather(out, self.mesh, self.dp, 0)
        return out[0]

    # -- attention ----------------------------------------------------------
    def _qkv(self, ps, xs, pos_of):
        """Per position: q (b, S, Hl, hd) and k, v (b, S, KVl, hd), rotated
        (``pos_of(p)``: the positions), each projection gathered over
        ``model`` where its block cuts a head."""
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        qs, ks, vs = [], [], []
        for p, x in zip(ps, xs):
            q, k, v = L.dense_apply_many(p, ("wq", "wk", "wv"), x)
            if "bq" in p:
                q = q + p["bq"].to(x.dtype)
                k = k + p["bk"].to(x.dtype)
                v = v + p["bv"].to(x.dtype)
            qs.append(q)
            ks.append(k)
            vs.append(v)
        if self.q_split and not self.q_heads:
            qs = self.gather_model(qs, -1)
        if self.kv_split and not self.kv_heads:
            ks, vs = self.gather_model(ks, -1), self.gather_model(vs, -1)
        out = []
        for p, (q, k, v) in enumerate(zip(qs, ks, vs)):
            q = q.reshape(*q.shape[:-1], -1, hd)
            k = k.reshape(*k.shape[:-1], -1, hd)
            v = v.reshape(*v.shape[:-1], -1, hd)
            if cfg.rope_theta:
                q = L.rope(q, pos_of(p), cfg.rope_theta)
                k = L.rope(k, pos_of(p), cfg.rope_theta)
            out.append((q, k, v))
        return out

    def _q_range(self, p: int) -> Tuple[int, int]:
        """The query heads position p attends."""
        H = self.cfg.num_heads
        if not self.q_heads:
            return 0, H
        n = H // self.M
        return self.mi[p] * n, (self.mi[p] + 1) * n

    def _kv_view(self, p: int, t: torch.Tensor) -> torch.Tensor:
        """The heads (dim 2) of k or v that position p's query heads read:
        t holds the position's own KV heads, or every KV head."""
        if t.shape[2] != self.cfg.num_kv_heads:
            return t                       # its own heads: block p of p
        G = self.cfg.num_heads // self.cfg.num_kv_heads
        return _pick(t, *_heads_for(*self._q_range(p), G))

    def _out(self, ps, os_):
        """wo on each position's (b, S, Hl * hd) attention output, sliced
        to its wo rows where the heads were gathered; summed over model
        where wo is row-split."""
        ys = []
        for p, (pp, o) in enumerate(zip(ps, os_)):
            if self.q_split and not self.q_heads:
                n = pp["wo"].shape[0]
                o = o[..., self.mi[p] * n:(self.mi[p] + 1) * n]
            ys.append(L.dense_apply(pp, "wo", o))
        return self.sum_model(ys) if self.q_split else ys

    def attn_prefill(self, ps, xs, positions):
        """Full-sequence attention at every position: (y list, k list, v
        list), k and v (b, S, KVl, hd) as the cache holds them."""
        cfg = self.cfg
        qkv = self._qkv(ps, xs, lambda p: positions[p])
        os_ = []
        for p, (q, k, v) in enumerate(qkv):
            out = L.flash_attention(q.transpose(1, 2),
                                    self._kv_view(p, k).transpose(1, 2),
                                    self._kv_view(p, v).transpose(1, 2),
                                    causal=True, window=cfg.sliding_window)
            os_.append(out.transpose(1, 2).reshape(*q.shape[:2], -1))
        ys = self._out(ps, os_)
        return ys, [t[1] for t in qkv], [t[2] for t in qkv]

    def attn_decode(self, ps, xs, pos: int, ck, cv, kpos):
        """One token at every position against its cache blocks (b, Sc,
        KVl, hd), written in place; the read over the heads it holds."""
        cfg = self.cfg
        qkv = self._qkv(ps, xs, lambda p: L._positions(pos, xs[p].device))
        os_ = []
        for p, (q, k, v) in enumerate(qkv):
            slot = L.cache_slot(cfg, pos, ck[p].shape[1])
            ck[p][:, slot] = k[:, 0]
            cv[p][:, slot] = v[:, 0]
            kk, vv = self._kv_view(p, ck[p]), self._kv_view(p, cv[p])
            b, _, hl, hd = q.shape
            out = L.flash_decode(q[:, 0].reshape(b, kk.shape[2], -1, hd),
                                 kk, vv, kpos[p], pos,
                                 window=cfg.sliding_window)
            os_.append(out.reshape(b, 1, hl * hd))
        return self._out(ps, os_)

    def attn_decode_seq(self, ps, xs, pos: int, ck, cv, kpos, seq_axes):
        """One token against a cache whose sequence is split over
        ``seq_axes`` (blocks (b, Sc_i, KV, hd), every head): the query and
        the new k, v gathered to every head over ``model``, the owner shard
        takes k and v, each group of positions over the same rows reads
        its shards (each at its position, with its lse) and combines them
        on its first position."""
        cfg = self.cfg
        KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        qkv = self._qkv(ps, xs, lambda p: L._positions(pos, xs[p].device))
        qs, ks, vs = ([t[i] for t in qkv] for i in range(3))
        if self.q_heads:
            qs = self.gather_model(qs, 2)
        if self.kv_heads:
            ks, vs = self.gather_model(ks, 2), self.gather_model(vs, 2)
        os_: List[torch.Tensor] = [None] * self.n
        for g in C.groups(self.mesh, seq_axes):
            sizes = [ck[p].shape[1] for p in g]
            owner, slot = L.shard_slot(cfg, pos, sizes)
            o = g[owner]
            ck[o][:, slot] = ks[o][:, 0]
            cv[o][:, slot] = vs[o][:, 0]
            q = qs[g[0]]
            b = q.shape[0]
            out = L.flash_decode_sharded(
                q[:, 0].reshape(b, KV, -1, hd), [ck[p] for p in g],
                [cv[p] for p in g], [kpos[p] for p in g], pos,
                window=cfg.sliding_window)
            for p in g:
                os_[p] = out.reshape(b, 1, -1).to(self.devices[p])
        if self.q_heads:
            # every head's output: each position's wo rows are its heads'
            n = cfg.num_heads // self.M * hd
            os_ = [o[..., self.mi[p] * n:(self.mi[p] + 1) * n]
                   for p, o in enumerate(os_)]
        return self._out(ps, os_)

    # -- mamba --------------------------------------------------------------
    def _mamba_split(self) -> bool:
        return self.split(("blocks", "mamba", "conv_w"), -1)

    def _mamba(self, ps, xs, scan, conv_states=None):
        """The mixer at every position on its channels: (y list, state
        list, conv state list); ``scan(p, xc, dt, Bm, Cm, A)`` -> (y, h)."""
        cfg = self.cfg
        split = self._mamba_split()
        pre = []
        for p, (pp, x) in enumerate(zip(ps, xs)):
            xz = x @ pp["in_proj"].flatten(-2).to(x.dtype)
            xc, z, conv = L.mamba_conv(pp, cfg, xz, None if conv_states is None
                                       else conv_states[p])
            pre.append((xc, z, conv, xc @ pp["x_proj"].to(xc.dtype)))
        dbcs = [t[3] for t in pre]
        if split:
            dbcs = self.sum_model(dbcs)
        ys, hs = [], []
        for p, (pp, x, (xc, z, _, _)) in enumerate(zip(ps, xs, pre)):
            dt, Bm, Cm, A = L.mamba_ssm_inputs(pp, cfg, dbcs[p])
            y, h = scan(p, xc, dt, Bm, Cm, A)
            ys.append(L.mamba_gate(pp, x.dtype, y, xc, z))
            hs.append(h)
        if split:
            ys = self.gather_model(ys, -1)
        out = [y @ pp["out_proj"].to(y.dtype) for pp, y in zip(ps, ys)]
        return out, hs, [t[2] for t in pre]

    def mamba_prefill(self, ps, xs):
        return self._mamba(ps, xs, lambda p, *a: L.ssm_scan(*a))

    def mamba_decode(self, ps, xs, ssm, conv):
        return self._mamba(ps, xs, lambda p, *a: L.ssm_step(ssm[p], *a),
                           conv)

    # -- feed-forward -------------------------------------------------------
    def ffn(self, lp, hs):
        """The norm2 + MLP / MoE residual at every position."""
        cfg = self.cfg
        if not cfg.d_ff:
            return hs
        xs = [L.apply_norm(p["norm2"], cfg, h) for p, h in zip(lp, hs)]
        ps = [p["ffn"] for p in lp]
        if cfg.is_moe:
            ys = self._moe(ps, xs)
        else:
            ys = [L.apply_mlp(p, cfg, x) for p, x in zip(ps, xs)]
            down = "w_down" if cfg.act == "silu" else "w_out"
            if self.split(("blocks", "ffn", down), 1):
                ys = self.sum_model(ys)
        return [h + y for h, y in zip(hs, ys)]

    def _moe(self, ps, xs):
        cfg = self.cfg
        experts = self.split(("blocks", "ffn", "w_gate"), 1)
        dims = self.split(("blocks", "ffn", "w_down"), 2)
        row = perf_flags.FLAGS.moe_row_dispatch
        gathered = not row and self.b_split
        if gathered:
            # the global dispatch's capacity counts every token of the batch
            xs = C.all_gather(xs, self.mesh, self.dp, 0)
        ys = []
        for p, (pp, x) in enumerate(zip(ps, xs)):
            first = self.mi[p] * pp["w_gate"].shape[0] if experts else 0
            if row:
                y = L._apply_moe_row(pp, cfg, x, first)[0]
            else:
                y = L._apply_moe_row(pp, cfg, x.reshape(1, -1, x.shape[-1]),
                                     first)[0].reshape(x.shape)
            ys.append(y[self.rows(p)] if gathered else y)
        return self.sum_model(ys) if experts or dims else ys

    # -- cache layout -------------------------------------------------------
    def seq_axes(self) -> Tuple[str, ...]:
        """The axes a sequence-split cache runs over (``cache_pspecs``)."""
        return self.model if self.b_split or not self.dp else (
            self.dp + self.model)


def _seq_entry(run: Run, Sc: int):
    """The cache's sequence entry under ``decode_shard_map``, None where
    its axes do not divide the slots."""
    axes = run.seq_axes()
    if not axes or Sc % C.axis_size(run.mesh, axes):
        return None
    return axes if len(axes) > 1 else axes[0]


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor, mesh, *,
            extra_embed: Optional[torch.Tensor] = None,
            cache_dtype=torch.bfloat16, max_len: Optional[int] = None,
            compute_dtype=None, seq_shard: bool = False):
    """``lm.prefill`` on a tree placed over ``mesh``: (the last position's
    logits (B, V), whole on the first position's device; the cache laid
    out over the mesh, its sequence split when ``seq_shard``)."""
    cdt = L.COMPUTE_DTYPE if compute_dtype is None else compute_dtype
    B = tokens.shape[0]
    run = Run(cfg, mesh, params, B)
    extra = None if extra_embed is None else run.split_rows(extra_embed)
    hs, positions = run.embed(run.split_rows(tokens), 0, cdt, extra)
    S = hs[0].shape[1]
    Lc, hd = cfg.num_layers, cfg.resolved_head_dim
    cache: Params = {"pos": S}
    kc = vc = kpos = ssm = conv = None
    if cfg.has_attention:
        Sc = cache_len(cfg, max(S, max_len or S))
        keep = min(S, Sc)
        roll = S % Sc if Sc == keep and cfg.sliding_window else 0
        kpos = []
        for p in range(run.n):
            kp = torch.full((Sc,), -1, dtype=torch.int32,
                            device=run.devices[p])
            kp[:keep] = positions[p][S - keep:]
            kpos.append(torch.roll(kp, roll) if roll else kp)
        kc, vc = [], []
    if cfg.has_ssm:
        ssm, conv = [], []
    for i in range(Lc):
        lp = run.layer(i)
        xs = [L.apply_norm(p["norm1"], cfg, h) for p, h in zip(lp, hs)]
        a = m = [None] * run.n
        if cfg.has_attention:
            a, ks, vs = run.attn_prefill([p["attn"] for p in lp], xs,
                                         positions)
            for p, (k, v) in enumerate(zip(ks, vs)):
                if i == 0:
                    shape = (Lc, run.b, Sc, k.shape[2], hd)
                    kc.append(torch.zeros(shape, dtype=cache_dtype,
                                          device=run.devices[p]))
                    vc.append(torch.zeros_like(kc[-1]))
                for buf, t in ((kc[p], k), (vc[p], v)):
                    tail = t[:, S - keep:]
                    buf[i, :, :keep] = (torch.roll(tail, roll, 1) if roll
                                        else tail)
        if cfg.has_ssm:
            m, hst, cst = run.mamba_prefill([p["mamba"] for p in lp], xs)
            if i == 0:
                ssm = [torch.zeros((Lc,) + h.shape, dtype=torch.float32,
                                   device=h.device) for h in hst]
                conv = [torch.zeros((Lc,) + c.shape, dtype=cache_dtype,
                                    device=c.device) for c in cst]
            for p in range(run.n):
                ssm[p][i], conv[p][i] = hst[p], cst[p]
        hs = run.ffn(lp, [_mix(cfg, h, a[p], m[p])
                          for p, h in enumerate(hs)])
    logits = run.unembed([h[:, -1:] for h in hs])[:, 0]
    if cfg.has_attention:
        cache.update(_attn_cache(run, kc, vc, kpos, seq_shard))
    if cfg.has_ssm:
        model = "model" if run._mamba_split() else None
        DI, N, CK = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
        cache["ssm"] = sharding.Sharded.of(
            mesh, (None, run.b_spec, model, None), (Lc, B, DI, N), ssm)
        cache["conv"] = sharding.Sharded.of(
            mesh, (None, run.b_spec, None, model), (Lc, B, CK - 1, DI), conv)
    return logits, cache


def _attn_cache(run: Run, kc, vc, kpos, seq_shard: bool) -> Params:
    """The k, v and kpos leaves over the mesh: the heads as the projections
    left them, or every head with the sequence split."""
    mesh, KV = run.mesh, run.cfg.num_kv_heads
    Lc, _, Sc, _, hd = kc[0].shape
    B = run.b * C.axis_size(mesh, run.dp) if run.b_split else run.b
    shape = (Lc, B, Sc, KV, hd)
    seq = _seq_entry(run, Sc) if seq_shard else None
    if seq is None:
        heads = "model" if kc[0].shape[3] != KV else None
        spec = (None, run.b_spec, None, heads, None)
        return {"k": sharding.Sharded.of(mesh, spec, shape, kc),
                "v": sharding.Sharded.of(mesh, spec, shape, vc),
                "kpos": sharding.Sharded.of(mesh, (), (Sc,), kpos)}
    if run.kv_heads:
        kc, vc = run.gather_model(kc, 3), run.gather_model(vc, 3)
    axes = _entry(seq)
    n = Sc // C.axis_size(mesh, axes)

    def cut(blocks, dim):
        return [t.narrow(dim, C.axis_index(mesh, p, axes) * n, n).clone()
                for p, t in enumerate(blocks)]

    spec = (None, run.b_spec, seq, None, None)
    return {"k": sharding.Sharded.of(mesh, spec, shape, cut(kc, 2)),
            "v": sharding.Sharded.of(mesh, spec, shape, cut(vc, 2)),
            "kpos": sharding.Sharded.of(mesh, (seq,), (Sc,), cut(kpos, 0))}


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache: Params, mesh, *, compute_dtype=None):
    """``lm.decode_step`` on a tree placed over ``mesh`` and a cache laid
    out by ``prefill``: (logits (B, V), whole on the first position's
    device; the cache, written in place, ``pos`` advanced)."""
    cdt = L.COMPUTE_DTYPE if compute_dtype is None else compute_dtype
    run = Run(cfg, mesh, params, token.shape[0])
    pos = cache["pos"]
    hs, _ = run.embed(run.split_rows(token[:, None]), pos, cdt)
    ck = cv = kpos = seq_axes = None
    if cfg.has_attention:
        ck, cv = cache["k"].blocks, cache["v"].blocks
        kpos = cache["kpos"].blocks
        seq = cache["k"].spec[2]
        if seq is None:
            for p, kp in enumerate(kpos):
                kp[L.cache_slot(cfg, pos, kp.shape[0])] = pos
        else:
            seq_axes = _entry(seq)
            for g in C.groups(mesh, seq_axes):
                owner, slot = L.shard_slot(cfg, pos,
                                           [kpos[p].shape[0] for p in g])
                kpos[g[owner]][slot] = pos
    for i in range(cfg.num_layers):
        lp = run.layer(i)
        xs = [L.apply_norm(p["norm1"], cfg, h) for p, h in zip(lp, hs)]
        a = m = [None] * run.n
        if cfg.has_attention:
            ps = [p["attn"] for p in lp]
            cki, cvi = [t[i] for t in ck], [t[i] for t in cv]
            if seq_axes is None:
                a = run.attn_decode(ps, xs, pos, cki, cvi, kpos)
            else:
                a = run.attn_decode_seq(ps, xs, pos, cki, cvi, kpos,
                                        seq_axes)
        if cfg.has_ssm:
            ssm, conv = cache["ssm"].blocks, cache["conv"].blocks
            m, hst, cst = run.mamba_decode(
                [p["mamba"] for p in lp], xs, [t[i] for t in ssm],
                [t[i] for t in conv])
            for p in range(run.n):
                ssm[p][i], conv[p][i] = hst[p], cst[p]
        hs = run.ffn(lp, [_mix(cfg, h, a[p], m[p])
                          for p, h in enumerate(hs)])
    return run.unembed(hs)[:, 0], {**cache, "pos": pos + 1}


__all__ = ["Run", "prefill", "decode_step"]
