"""Serving and training over a ``(data, model)`` mesh, run in one process
over the mesh's positions: the decoders' steps (``prefill``,
``decode_step``), whisper's encoder-decoder steps (``encdec_prefill``,
``encdec_decode_step``), the embedder's forward (``embed``, which
``core.sharded_backend`` serves) and the training forwards (``forward``,
``encdec_forward``, which ``steps.train`` differentiates: autograd runs
back through the collectives, a gather's backward slicing its gradient
into the blocks and a sum's handing its gradient to every member).

Each takes a param tree placed over the mesh
(``parallel.sharding.shard_tree`` under ``steps/serve.serve_shardings``,
``serve_embed_shardings`` for the embedder, ``steps/train.train_shardings``
for training) and runs each layer at
every position in turn, on that position's blocks; what GSPMD inserts
between the reference's sharded operands is here an explicit collective
of ``parallel.collectives``:

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
* int8 projections (a quantized embedder tree): a column-split weight's
  position cuts its columns out of the whole ``{name}_scale``; a row-split
  one applies the whole scale to its partial.  Under W8A8 a row is
  quantized against its whole absmax, as the reference quantizes it: for
  a row-split weight the position gathers the input over ``model``,
  quantizes the whole row and multiplies its columns of the codes;
* whisper: the encoder, the decoder's self attention and its cross
  attention each read their own stack's projections (``enc_blocks``,
  ``dec_blocks`` ``attn`` / ``xattn``), each on the position's heads or,
  where the block cuts a head, on every head gathered; a decode step's
  cross attention is plain ops (``layers.cross_attend``) on the
  position's heads of the cross cache;
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

The cache is a dict of ``Sharded`` leaves and ``pos``: ``k``/``v`` (and
whisper's ``cross_k``/``cross_v``) with the batch over the data axes and
the heads as the K/V projections leave them,
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

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import perf_flags
from repro_torch.configs.base import ModelConfig
from repro_torch.models import embedder as E
from repro_torch.models import layers as L
from repro_torch.models.lm import _mix, _remat, add_positions, cache_len
from repro_torch.models.quantize import SCALE_SUFFIX
from repro_torch.parallel import collectives as C
from repro_torch.parallel import sharding

Params = Dict[str, Any]
MODEL = ("model",)
ATTN = ("blocks", "attn")


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


@dataclass(frozen=True)
class Heads:
    """How the projections of one attention block lie over ``model``:
    whether q's (k's) columns are split, and whether the split falls on
    head boundaries (else the projection is gathered)."""
    q_split: bool
    q_heads: bool
    kv_split: bool
    kv_heads: bool


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
        # the whole batch B, over the data axes where it splits evenly
        # (batch_pspecs): b rows a position
        self.B = batch
        self.b_split = dn > 1 and batch >= dn and batch % dn == 0
        self.b = batch // dn if self.b_split else batch
        self.b_spec = ((self.dp if len(self.dp) > 1 else self.dp[0])
                       if self.b_split else None)
        flat = _flat(params)
        self.specs = {k: s.spec for k, s in flat.items()}
        self.local = [_unflat({k: s.blocks[p] for k, s in flat.items()})
                      for p in range(self.n)]
        self._views: Dict[str, List[List[Params]]] = {}
        # the decoders' (and the embedder's) attention block
        self.attn = self.heads(ATTN)
        self.q_split, self.q_heads = self.attn.q_split, self.attn.q_heads
        self.kv_split, self.kv_heads = self.attn.kv_split, self.attn.kv_heads

    # -- layout -------------------------------------------------------------
    def heads(self, path: Tuple[str, ...]) -> Heads:
        """The layout of the attention block at ``path`` (a stack and its
        sub-dict, e.g. ``("dec_blocks", "xattn")``)."""
        q = self.split(path + ("wq",), -1)
        kv = self.split(path + ("wk",), -1)
        return Heads(q, q and self.cfg.num_heads % self.M == 0,
                     kv, kv and self.cfg.num_kv_heads % self.M == 0)

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
        layer dim indexed away, skipped), and each int8 weight's whole
        ``_scale`` cut to the columns the weight's block holds."""
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
        for path in flats[0]:
            if not path[-1].endswith(SCALE_SUFFIX):
                continue
            base = path[:-1] + (path[-1][:-len(SCALE_SUFFIX)],)
            spec = self.specs.get(prefix + base, ())[lead:]
            # the data part of the columns' split was gathered above
            axes = tuple(a for a in _entry(spec[-1] if spec else None)
                         if a not in self.dp)
            if not axes:
                continue
            for p, f in enumerate(flats):
                n, i = f[base].shape[-1], C.axis_index(self.mesh, p, axes)
                f[path] = f[path][..., i * n:(i + 1) * n]
        return [_unflat(f) for f in flats]

    def top(self, name: str) -> List[Any]:
        """A top-level leaf (or subtree) at every position, gathered."""
        return [t[name] for t in self._gather_data(
            [{name: loc[name]} for loc in self.local], (), 0)]

    def views(self, stack: str = "blocks") -> List[List[Params]]:
        """``stack``'s layers at every position, ungathered: each block
        unbound along its layer dim once (``lm.layer_views``; positions
        that share a block share its views), so under autograd a stacked
        block's gradient is stacked once, not added layer by layer."""
        if stack not in self._views:
            unbound: Dict[int, Tuple[torch.Tensor, ...]] = {}

            def cut(t):
                if id(t) not in unbound:
                    unbound[id(t)] = torch.unbind(t, 0)
                return unbound[id(t)]

            flats = [_flat(loc[stack]) for loc in self.local]
            n = next(iter(flats[0].values())).shape[0]
            self._views[stack] = [
                [_unflat({k: cut(t)[i] for k, t in f.items()})
                 for f in flats] for i in range(n)]
        return self._views[stack]

    def gather_layer(self, views: List[Params],
                     stack: str = "blocks") -> List[Params]:
        """One layer's ``views`` (a position each) gathered over the data
        axes where their specs split them."""
        return self._gather_data(views, (stack,), 1)

    def layer(self, i: int, stack: str = "blocks") -> List[Params]:
        """Layer i of ``stack``'s params at every position, gathered."""
        return self.gather_layer(self.views(stack)[i], stack)

    def sum_model(self, xs):
        return C.all_reduce_sum(xs, self.mesh, self.model)

    def gather_model(self, xs, dim: int):
        return C.all_gather(xs, self.mesh, self.model, dim)

    # -- embedding and head -------------------------------------------------
    def tok_embed(self, toks, cdt) -> List[torch.Tensor]:
        """The token rows of the embedding at every position, in ``cdt``:
        a vocab split over ``model`` is summed (a token outside a
        position's rows adds zeros)."""
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
        return self.sum_model(hs) if vsplit else hs

    def embed(self, toks, pos_offset: int, cdt, extra=None):
        """Token embeddings at every position (h list, positions list)."""
        hs = self.tok_embed(toks, cdt)
        out = [add_positions(self.cfg, h, pos_offset,
                             None if extra is None else extra[p])
               for p, h in enumerate(hs)]
        return [o[0] for o in out], [o[1] for o in out]

    def head(self) -> Tuple[List[torch.Tensor], bool]:
        """The unembedding (D, V) block at every position, gathered over
        the data axes (the embedding's transpose when tied), and whether
        its vocab columns are split over ``model``."""
        if self.cfg.tie_embeddings:
            return ([e.T for e in self.top("embed")],
                    self.split(("embed",), 0))
        return self.top("lm_head"), self.split(("lm_head",), -1)

    def unembed(self, hs, norm: str = "final_norm") -> torch.Tensor:
        """The whole logits (B, S, V) of hs, after the ``norm`` leaf, on
        the first position's device."""
        cfg = self.cfg
        norm = self.top(norm)
        heads, vsplit = self.head()
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
    def _qkv(self, ps, xs, pos_of, lay: Heads, kv_xs=None,
             act_quant: bool = False):
        """Per position: q (b, S, Hl, hd) and k, v (b, Skv, KVl, hd), k and
        v from ``kv_xs`` (cross attention) or from xs, rotated in self
        attention (``pos_of(p)``: the positions), each projection gathered
        over ``model`` where its block cuts a head."""
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        qs, ks, vs = [], [], []
        for i, (p, x) in enumerate(zip(ps, xs)):
            if kv_xs is None:
                q, k, v = L.dense_apply_many(p, ("wq", "wk", "wv"), x,
                                             act_quant)
            else:
                q = L.dense_apply(p, "wq", x, act_quant)
                k, v = L.dense_apply_many(p, ("wk", "wv"), kv_xs[i],
                                          act_quant)
            if "bq" in p:
                q = q + p["bq"].to(x.dtype)
                k = k + p["bk"].to(x.dtype)
                v = v + p["bv"].to(x.dtype)
            qs.append(q)
            ks.append(k)
            vs.append(v)
        if lay.q_split and not lay.q_heads:
            qs = self.gather_model(qs, -1)
        if lay.kv_split and not lay.kv_heads:
            ks, vs = self.gather_model(ks, -1), self.gather_model(vs, -1)
        out = []
        for p, (q, k, v) in enumerate(zip(qs, ks, vs)):
            q = q.reshape(*q.shape[:-1], -1, hd)
            k = k.reshape(*k.shape[:-1], -1, hd)
            v = v.reshape(*v.shape[:-1], -1, hd)
            if cfg.rope_theta and kv_xs is None:
                q = L.rope(q, pos_of(p), cfg.rope_theta)
                k = L.rope(k, pos_of(p), cfg.rope_theta)
            out.append((q, k, v))
        return out

    def _q_range(self, p: int, lay: Heads) -> Tuple[int, int]:
        """The query heads position p attends."""
        H = self.cfg.num_heads
        if not lay.q_heads:
            return 0, H
        n = H // self.M
        return self.mi[p] * n, (self.mi[p] + 1) * n

    def _kv_view(self, p: int, t: torch.Tensor, lay: Heads) -> torch.Tensor:
        """The heads (dim 2) of k or v that position p's query heads read:
        t holds the position's own KV heads, or every KV head."""
        if t.shape[2] != self.cfg.num_kv_heads:
            return t                       # its own heads: block p of p
        G = self.cfg.num_heads // self.cfg.num_kv_heads
        return _pick(t, *_heads_for(*self._q_range(p, lay), G))

    def _out(self, ps, os_, lay: Heads, act_quant: bool = False):
        """wo on each position's (b, S, Hl * hd) attention output (every
        head's where the heads were gathered), summed over model where wo
        is row-split."""
        if not lay.q_split:
            return [L.dense_apply(pp, "wo", o, act_quant)
                    for pp, o in zip(ps, os_)]
        return self.rows_proj(ps, "wo", os_, act_quant,
                              whole=not lay.q_heads)

    def rows_proj(self, ps, name: str, xs, act_quant: bool = False,
                  whole: bool = False):
        """``x @ p[name]`` for a weight whose rows are split over
        ``model``, summed over it: xs[p] holds the columns of x that
        position p's rows take or, with ``whole``, every column (cut
        here).  Under W8A8 (an int8 weight, ``act_quant``) each row is
        quantized against its whole absmax, as the reference quantizes
        it: the position quantizes the whole row (gathered over ``model``
        where it holds only its columns) and multiplies its columns of the
        codes by its rows, with the row's scale and the whole weight
        scale."""
        quant = act_quant and name + SCALE_SUFFIX in ps[0]
        if quant and not whole:
            xs, whole = self.gather_model(xs, -1), True
        ys = []
        for p, (pp, x) in enumerate(zip(ps, xs)):
            n = pp[name].shape[0]
            cols = (slice(self.mi[p] * n, (self.mi[p] + 1) * n) if whole
                    else slice(None))
            if quant:
                x8, x_scale = L.quantize_rows(x)
                ys.append(L.w8a8_matmul(x8[..., cols], pp[name], x_scale,
                                        pp[name + SCALE_SUFFIX],
                                        out_dtype=x.dtype))
            else:
                ys.append(L.dense_apply(pp, name, x[..., cols]))
        return self.sum_model(ys)

    def attn_prefill(self, ps, xs, positions, lay: Optional[Heads] = None,
                     *, causal: bool = True, kv_len=None, kv_xs=None,
                     act_quant: bool = False):
        """Full-sequence attention at every position: (y list, k list, v
        list), k and v (b, Skv, KVl, hd) as the cache holds them.  Self
        attention, causal under the config's window or bidirectional with
        each position's ``kv_len`` rows, or cross attention over
        ``kv_xs``."""
        cfg = self.cfg
        lay = lay or self.attn
        qkv = self._qkv(ps, xs, lambda p: positions[p], lay, kv_xs,
                        act_quant)
        os_ = []
        for p, (q, k, v) in enumerate(qkv):
            out = L.flash_attention(
                q.transpose(1, 2), self._kv_view(p, k, lay).transpose(1, 2),
                self._kv_view(p, v, lay).transpose(1, 2), causal=causal,
                window=cfg.sliding_window if causal else 0,
                kv_len=None if kv_len is None else kv_len[p])
            os_.append(out.transpose(1, 2).reshape(*q.shape[:2], -1))
        ys = self._out(ps, os_, lay, act_quant)
        return ys, [t[1] for t in qkv], [t[2] for t in qkv]

    def attn_decode(self, ps, xs, pos: int, ck, cv, kpos,
                    lay: Optional[Heads] = None):
        """One token at every position against its cache blocks (b, Sc,
        KVl, hd), written in place; the read over the heads it holds."""
        cfg = self.cfg
        lay = lay or self.attn
        qkv = self._qkv(ps, xs, lambda p: L._positions(pos, xs[p].device),
                        lay)
        os_ = []
        for p, (q, k, v) in enumerate(qkv):
            slot = L.cache_slot(cfg, pos, ck[p].shape[1])
            ck[p][:, slot] = k[:, 0]
            cv[p][:, slot] = v[:, 0]
            kk, vv = self._kv_view(p, ck[p], lay), self._kv_view(p, cv[p], lay)
            b, _, hl, hd = q.shape
            out = L.flash_decode(q[:, 0].reshape(b, kk.shape[2], -1, hd),
                                 kk, vv, kpos[p], pos,
                                 window=cfg.sliding_window)
            os_.append(out.reshape(b, 1, hl * hd))
        return self._out(ps, os_, lay)

    def cross_decode(self, ps, xs, cks, cvs, lay: Heads):
        """One token's cross attention at every position against its
        blocks of the cross cache (b, F, KVl, hd), in plain ops
        (``layers.cross_attend``) over the heads it holds."""
        hd = self.cfg.resolved_head_dim
        qs = [x @ pp["wq"].to(x.dtype) for pp, x in zip(ps, xs)]
        if lay.q_split and not lay.q_heads:
            qs = self.gather_model(qs, -1)
        os_ = [L.cross_attend(q, self._kv_view(p, cks[p], lay),
                              self._kv_view(p, cvs[p], lay), hd)
               for p, q in enumerate(qs)]
        return self._out(ps, os_, lay)

    def attn_decode_seq(self, ps, xs, pos: int, ck, cv, kpos, seq_axes):
        """One token against a cache whose sequence is split over
        ``seq_axes`` (blocks (b, Sc_i, KV, hd), every head): the query and
        the new k, v gathered to every head over ``model``, the owner shard
        takes k and v, each group of positions over the same rows reads
        its shards (each at its position, with its lse) and combines them
        on its first position."""
        cfg = self.cfg
        KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        qkv = self._qkv(ps, xs, lambda p: L._positions(pos, xs[p].device),
                        self.attn)
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
        return self._out(ps, os_, self.attn)

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
    def ffn(self, lp, hs, stack: str = "blocks", act_quant: bool = False):
        """The norm2 + MLP / MoE residual at every position, on layer
        params ``lp`` of ``stack``."""
        return self.ffn_aux(lp, hs, stack, act_quant)[0]

    def ffn_aux(self, lp, hs, stack: str = "blocks",
                act_quant: bool = False):
        """``ffn`` and the MoE load-balance loss of the whole batch at every
        position (None for a dense block)."""
        cfg = self.cfg
        if not cfg.d_ff:
            return hs, None
        xs = [L.apply_norm(p["norm2"], cfg, h) for p, h in zip(lp, hs)]
        ps = [p["ffn"] for p in lp]
        down = "w_down" if cfg.act == "silu" else "w_out"
        aux = None
        if cfg.is_moe:
            ys, aux = self._moe(ps, xs)
        elif self.split((stack, "ffn", down), 1):
            ys = self.rows_proj(ps, down, [
                L.mlp_hidden(p, cfg, x, act_quant) for p, x in zip(ps, xs)],
                act_quant)
        else:
            ys = [L.apply_mlp(p, cfg, x, act_quant) for p, x in zip(ps, xs)]
        return [h + y for h, y in zip(hs, ys)], aux

    def _moe(self, ps, xs):
        """(the MoE outputs, the whole batch's load-balance loss) at every
        position."""
        cfg = self.cfg
        experts = self.split(("blocks", "ffn", "w_gate"), 1)
        dims = self.split(("blocks", "ffn", "w_down"), 2)
        row = perf_flags.FLAGS.moe_row_dispatch
        gathered = not row and self.b_split
        if gathered:
            # the global dispatch's capacity counts every token of the batch
            xs = C.all_gather(xs, self.mesh, self.dp, 0)
        ys, auxs = [], []
        for p, (pp, x) in enumerate(zip(ps, xs)):
            first = self.mi[p] * pp["w_gate"].shape[0] if experts else 0
            if row:
                y, aux = L._apply_moe_row(pp, cfg, x, first)
            else:
                y, aux = L._apply_moe_row(
                    pp, cfg, x.reshape(1, -1, x.shape[-1]), first)
                y = y.reshape(x.shape)
            ys.append(y[self.rows(p)] if gathered else y)
            auxs.append(aux)
        if row and self.b_split:
            auxs = self._row_aux(ps, xs)
        return (self.sum_model(ys) if experts or dims else ys), auxs

    def _row_aux(self, ps, xs) -> List[torch.Tensor]:
        """Under ``moe_row_dispatch`` with the batch split over the data
        axes: the whole batch's load-balance loss from each position's
        router probabilities and assignment counts, summed over the data
        axes (a position's own loss covers its rows only)."""
        cfg = self.cfg
        E, K = cfg.num_experts, cfg.experts_per_token
        stats = []
        for pp, x in zip(ps, xs):
            probs, _, eidx = L.moe_route(pp, cfg, x)
            counts = torch.zeros(E, dtype=torch.float32, device=x.device)
            counts.index_add_(0, eidx.reshape(-1),
                              torch.ones(eidx.numel(), device=x.device))
            stats.append(torch.cat([probs.sum((0, 1)), counts]))
        n = self.B * xs[0].shape[1]
        return [E * (t[:E] / n * (t[E:] / (n * K))).sum()
                for t in C.all_reduce_sum(stats, self.mesh, self.dp)]

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


def _heads_leaf(run: Run, blocks, Lc: int, S: int) -> sharding.Sharded:
    """A (Lc, B, S, KV, hd) cache leaf from each position's blocks, its
    heads over ``model`` where the projections left them split."""
    cfg = run.cfg
    heads = "model" if blocks[0].shape[3] != cfg.num_kv_heads else None
    return sharding.Sharded.of(
        run.mesh, (None, run.b_spec, None, heads, None),
        (Lc, run.B, S, cfg.num_kv_heads, cfg.resolved_head_dim), blocks)


def _attn_cache(run: Run, kc, vc, kpos, seq_shard: bool) -> Params:
    """The k, v and kpos leaves over the mesh: the heads as the projections
    left them, or every head with the sequence split."""
    mesh = run.mesh
    Lc, _, Sc, _, hd = kc[0].shape
    seq = _seq_entry(run, Sc) if seq_shard else None
    if seq is None:
        return {"k": _heads_leaf(run, kc, Lc, Sc),
                "v": _heads_leaf(run, vc, Lc, Sc),
                "kpos": sharding.Sharded.of(mesh, (), (Sc,), kpos)}
    if run.attn.kv_heads:
        kc, vc = run.gather_model(kc, 3), run.gather_model(vc, 3)
    axes = _entry(seq)
    n = Sc // C.axis_size(mesh, axes)

    def cut(blocks, dim):
        return [t.narrow(dim, C.axis_index(mesh, p, axes) * n, n).clone()
                for p, t in enumerate(blocks)]

    spec = (None, run.b_spec, seq, None, None)
    shape = (Lc, run.B, Sc, run.cfg.num_kv_heads, hd)
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


# -- training -----------------------------------------------------------------
def _aux_total(run: Run, auxs) -> torch.Tensor:
    """The layers' load-balance losses (the first position's of each: every
    position holds the whole batch's) summed, 0-dim fp32 on the first
    position's device, as ``lm.forward`` sums them."""
    if auxs:
        return torch.stack(auxs).sum()
    return torch.zeros((), dtype=torch.float32, device=run.devices[0])


def _final(run: Run, hs, norm: str) -> List[torch.Tensor]:
    norms = run.top(norm)
    return [L.apply_norm(norms[p], run.cfg, h) for p, h in enumerate(hs)]


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, mesh, *,
            extra_embed: Optional[torch.Tensor] = None, compute_dtype=None
            ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """``lm.forward(..., remat=True, return_hidden=True)`` on a tree placed
    over ``mesh``: (every position's final-normed hidden states of its
    batch rows (b, S, D), a list in mesh order; the MoE load-balance loss
    summed over the layers, 0-dim fp32 on the first position's device).

    Each layer runs under ``lm._remat`` on the positions' ungathered blocks
    (``Run.views``): the FSDP gathers over the data axes happen inside the
    rematerialised function, so a gathered weight is neither saved for the
    backward nor held past its layer; the backward gathers it again."""
    cdt = L.COMPUTE_DTYPE if compute_dtype is None else compute_dtype
    run = Run(cfg, mesh, params, tokens.shape[0])
    extra = None if extra_embed is None else run.split_rows(extra_embed)
    hs, positions = run.embed(run.split_rows(tokens), 0, cdt, extra)

    def layer(hs, views):
        lp = run.gather_layer(views)
        xs = [L.apply_norm(p["norm1"], cfg, h) for p, h in zip(lp, hs)]
        a = m = [None] * run.n
        if cfg.has_attention:
            a = run.attn_prefill([p["attn"] for p in lp], xs, positions)[0]
        if cfg.has_ssm:
            m = run.mamba_prefill([p["mamba"] for p in lp], xs)[0]
        return run.ffn_aux(lp, [_mix(cfg, h, a[p], m[p])
                                for p, h in enumerate(hs)])

    step = _remat(layer)
    auxs = []
    for views in run.views():
        hs, aux = step(hs, views)
        if aux is not None:
            auxs.append(aux[0])
    return _final(run, hs, "final_norm"), _aux_total(run, auxs)


def encdec_forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   frames: torch.Tensor, mesh, *, compute_dtype=None
                   ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """``encdec.forward(..., remat=True, return_hidden=True)`` on a tree
    placed over ``mesh``: (every position's final-normed decoder states of
    its rows, a list in mesh order; a zero auxiliary loss).  The encoder
    runs as ``encdec_prefill``'s, not rematerialised (as the whole
    ``encdec.forward``); each decoder layer runs under ``lm._remat`` with
    its gathers inside, as in ``forward``."""
    cdt = L.COMPUTE_DTYPE if compute_dtype is None else compute_dtype
    run = Run(cfg, mesh, params, tokens.shape[0])
    enc = _encode(run, run.split_rows(frames), cdt)
    hs, positions = run.embed(run.split_rows(tokens), 0, cdt)
    self_at, cross_at = (run.heads(("dec_blocks", "attn")),
                         run.heads(("dec_blocks", "xattn")))

    def layer(hs, enc, views):
        lp = run.gather_layer(views, "dec_blocks")
        xs = [L.apply_norm(p["norm1"], cfg, h) for p, h in zip(lp, hs)]
        a = run.attn_prefill([p["attn"] for p in lp], xs, positions,
                             self_at)[0]
        hs = [h + y for h, y in zip(hs, a)]
        xs = [L.apply_norm(p["norm_x"], cfg, h) for p, h in zip(lp, hs)]
        a = run.attn_prefill([p["xattn"] for p in lp], xs, positions,
                             cross_at, causal=False, kv_xs=enc)[0]
        return run.ffn(lp, [h + y for h, y in zip(hs, a)], "dec_blocks")

    step = _remat(layer)
    for views in run.views("dec_blocks"):
        hs = step(hs, enc, views)
    return _final(run, hs, "dec_norm"), _aux_total(run, [])


# -- the embedder -------------------------------------------------------------
def embed(params: Params, cfg: ModelConfig, tokens, mask, mesh, *,
          compute_dtype=None, act_quant: bool = False) -> torch.Tensor:
    """``embedder.embed`` on a tree placed over ``mesh``: the (B, D) fp32
    unit vectors, whole on the first position's device.

    ``tokens`` and ``mask`` are whole (B, S) tensors, or lists of each
    position's rows (the batch over the data axes, as ``Run.split_rows``
    and the serving backend's batch spec cut it).  Each layer runs on the
    position's heads with its rows' ``kv_len`` (bidirectional), its
    ``wo``/``w_out`` partials summed over ``model``; the final norm and
    ``pool_norm`` run on the replicated hidden state of each data group's
    rows, and the vectors are gathered over the data axes."""
    cdt = L.COMPUTE_DTYPE if compute_dtype is None else compute_dtype
    groups = C.groups(mesh, MODEL if "model" in mesh.shape else ())
    if isinstance(tokens, torch.Tensor):
        B = tokens.shape[0]
    else:
        B = sum(tokens[g[0]].shape[0] for g in groups)
    run = Run(cfg, mesh, params, B)
    if isinstance(tokens, torch.Tensor):
        tokens, mask = run.split_rows(tokens), run.split_rows(mask)
    S = tokens[0].shape[1]
    positions = [torch.arange(S, dtype=torch.int32, device=d)
                 for d in run.devices]
    hs = [h + L.sinusoidal_positions(pos, cfg.d_model).to(h.dtype)
          for h, pos in zip(run.tok_embed(tokens, cdt), positions)]
    kv_len = [(m != 0).sum(-1).to(torch.int32) for m in mask]
    for i in range(params["blocks"]["norm1"]["scale"].shape[0]):
        lp = run.layer(i)
        xs = [L.apply_norm(p["norm1"], cfg, h) for p, h in zip(lp, hs)]
        a = run.attn_prefill([p["attn"] for p in lp], xs, positions,
                             causal=False, kv_len=kv_len,
                             act_quant=act_quant)[0]
        hs = run.ffn(lp, [h + y for h, y in zip(hs, a)],
                     act_quant=act_quant)
    norm = run.top("final_norm")
    pool = "mean" if cfg.pool == "mean" else "cls"
    out = [E.pool_norm(L.apply_norm(norm[p], cfg, h), mask[p], pool=pool)
           for p, h in enumerate(hs)]
    if run.b_split:
        out = C.all_gather(out, mesh, run.dp, 0)
    return out[0]


# -- whisper's encoder-decoder ------------------------------------------------
def _encode(run: Run, frames, cdt) -> List[torch.Tensor]:
    """``encdec.encode`` at every position on its rows of the frames."""
    cfg = run.cfg
    lay = run.heads(("enc_blocks", "attn"))
    F = frames[0].shape[1]
    positions = [torch.arange(F, dtype=torch.int32, device=d)
                 for d in run.devices]
    hs = [f.to(cdt) + L.sinusoidal_positions(pos, cfg.d_model).to(cdt)
          for f, pos in zip(frames, positions)]
    for i in range(cfg.encoder_layers):
        lp = run.layer(i, "enc_blocks")
        xs = [L.apply_norm(p["norm1"], cfg, h) for p, h in zip(lp, hs)]
        a = run.attn_prefill([p["attn"] for p in lp], xs, positions, lay,
                             causal=False)[0]
        hs = run.ffn(lp, [h + y for h, y in zip(hs, a)], "enc_blocks")
    norm = run.top("enc_norm")
    return [L.apply_norm(norm[p], cfg, h) for p, h in enumerate(hs)]


def encdec_prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   frames: torch.Tensor, mesh, *,
                   cache_dtype=torch.bfloat16, max_len: Optional[int] = None,
                   compute_dtype=None):
    """``encdec.prefill`` on a tree placed over ``mesh``: (the last
    position's logits (B, V), whole on the first position's device; the
    cache over the mesh).  The encoder runs on each position's rows of the
    frames and heads; each decoder layer's causal self attention and its
    cross attention (the prompt over the encoder's states) go through
    ``flash_attention`` on the position's heads.  The cache's ``k``/``v``
    and ``cross_k``/``cross_v`` hold the heads as the projections leave
    them (every head where a block cuts one)."""
    cdt = L.COMPUTE_DTYPE if compute_dtype is None else compute_dtype
    B, S = tokens.shape
    run = Run(cfg, mesh, params, B)
    enc = _encode(run, run.split_rows(frames), cdt)
    hs, positions = run.embed(run.split_rows(tokens), 0, cdt)
    self_at, cross_at = (run.heads(("dec_blocks", "attn")),
                         run.heads(("dec_blocks", "xattn")))
    Lc, F = cfg.num_layers, enc[0].shape[1]
    Sc = cache_len(cfg, max(S, max_len or S))
    kpos = []
    for p in range(run.n):
        kp = torch.full((Sc,), -1, dtype=torch.int32, device=run.devices[p])
        kp[:S] = positions[p]
        kpos.append(kp)
    bufs: Dict[str, List[torch.Tensor]] = {}
    for i in range(Lc):
        lp = run.layer(i, "dec_blocks")
        xs = [L.apply_norm(p["norm1"], cfg, h) for p, h in zip(lp, hs)]
        a, ks, vs = run.attn_prefill([p["attn"] for p in lp], xs, positions,
                                     self_at)
        hs = [h + y for h, y in zip(hs, a)]
        xs = [L.apply_norm(p["norm_x"], cfg, h) for p, h in zip(lp, hs)]
        a, xks, xvs = run.attn_prefill([p["xattn"] for p in lp], xs,
                                       positions, cross_at, causal=False,
                                       kv_xs=enc)
        hs = [h + y for h, y in zip(hs, a)]
        for name, ts, n in (("k", ks, Sc), ("v", vs, Sc),
                            ("cross_k", xks, F), ("cross_v", xvs, F)):
            if i == 0:
                bufs[name] = [torch.zeros((Lc, t.shape[0], n) + t.shape[2:],
                                          dtype=cache_dtype, device=t.device)
                              for t in ts]
            for buf, t in zip(bufs[name], ts):
                buf[i, :, :t.shape[1]] = t
        hs = run.ffn(lp, hs, "dec_blocks")
    logits = run.unembed([h[:, -1:] for h in hs], "dec_norm")[:, 0]
    cache: Params = {"pos": S,
                     "kpos": sharding.Sharded.of(mesh, (), (Sc,), kpos)}
    for name, n in (("k", Sc), ("v", Sc), ("cross_k", F), ("cross_v", F)):
        cache[name] = _heads_leaf(run, bufs[name], Lc, n)
    return logits, cache


def encdec_decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                       cache: Params, mesh, *, compute_dtype=None):
    """``encdec.decode_step`` on a tree placed over ``mesh`` and a cache
    laid out by ``encdec_prefill``: (logits (B, V), whole on the first
    position's device; the cache, written in place, ``pos`` advanced).
    The self attention reads the position's heads through
    ``flash_decode``, the cross attention its heads of the cross cache in
    plain ops."""
    cdt = L.COMPUTE_DTYPE if compute_dtype is None else compute_dtype
    run = Run(cfg, mesh, params, token.shape[0])
    pos = cache["pos"]
    hs, _ = run.embed(run.split_rows(token[:, None]), pos, cdt)
    self_at, cross_at = (run.heads(("dec_blocks", "attn")),
                         run.heads(("dec_blocks", "xattn")))
    ck, cv, kpos = (cache[k].blocks for k in ("k", "v", "kpos"))
    xk, xv = cache["cross_k"].blocks, cache["cross_v"].blocks
    for kp in kpos:
        kp[L.cache_slot(cfg, pos, kp.shape[0])] = pos
    for i in range(cfg.num_layers):
        lp = run.layer(i, "dec_blocks")
        xs = [L.apply_norm(p["norm1"], cfg, h) for p, h in zip(lp, hs)]
        a = run.attn_decode([p["attn"] for p in lp], xs, pos,
                            [t[i] for t in ck], [t[i] for t in cv], kpos,
                            self_at)
        hs = [h + y for h, y in zip(hs, a)]
        xs = [L.apply_norm(p["norm_x"], cfg, h) for p, h in zip(lp, hs)]
        a = run.cross_decode([p["xattn"] for p in lp], xs,
                             [t[i] for t in xk], [t[i] for t in xv],
                             cross_at)
        hs = run.ffn(lp, [h + y for h, y in zip(hs, a)], "dec_blocks")
    return run.unembed(hs, "dec_norm")[:, 0], {**cache, "pos": pos + 1}


__all__ = ["Run", "Heads", "prefill", "decode_step", "embed",
           "encdec_prefill", "encdec_decode_step", "forward",
           "encdec_forward"]
