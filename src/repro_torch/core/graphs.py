"""Computation DAG of the port's models (port of
``repro/core/graphs.py``).

Node names of quantizable ops match the ``qops`` op names exactly (and hence
the param paths), so the partition output indexes straight into sensitivity
results and MP assignments. Non-quantizable vertices (norms, softmax,
elementwise merges, residual adds) are included because they shape the
single-entry/single-exit structure.

Residual adds are recorded as *residual edges* so the partitioner can drop
them (paper Fig. 6 note). The graph mirrors the *serving* (prefill)
computation: the multi-token prediction block and training-only ops are
left out, so MTP ops get sensitivities but no group, and are never
quantized (the reference's ``pipeline.build_groups`` drops them alike). The
graph covers every block the port's ``LM`` builds — attention, MLA, mamba
and hybrid, each with a dense MLP, an MoE layer or neither — and the
encoder-decoder (``build_encdec_graph``, the reference's graph node for
node, its cross ``k_proj``/``v_proj`` fed by ``cross_norm`` as there);
``scan_layers`` raises with the slice that ports it.
"""
from __future__ import annotations

from repro_torch.core.partition import GraphSpec
from repro_torch.models.encdec import EncDec, EncDecConfig
from repro_torch.models.lm import LM, LMConfig

__all__ = ["build_graph", "build_lm_graph", "build_encdec_graph"]


def _attn_subgraph(g: GraphSpec, s: str, entry: str) -> str:
    """Standard attention: returns exit node name."""
    norm = g.add(f"{s}/attn_norm")
    g.edge(entry, norm)
    return _attn_shared_norm(g, s, norm)


def _attn_shared_norm(g: GraphSpec, s: str, norm: str) -> str:
    """Attention path when the input norm already exists (hybrid blocks)."""
    for proj in ("q_proj", "k_proj", "v_proj"):
        g.add(f"{s}/attn/{proj}", quantizable=True)
        g.edge(norm, f"{s}/attn/{proj}")
    qk = g.add(f"{s}/attn/qk_matmul", quantizable=True)
    g.edge(f"{s}/attn/q_proj", qk)
    g.edge(f"{s}/attn/k_proj", qk)
    sm = g.add(f"{s}/attn/softmax")
    g.edge(qk, sm)
    av = g.add(f"{s}/attn/av_matmul", quantizable=True)
    g.edge(sm, av)
    g.edge(f"{s}/attn/v_proj", av)
    o = g.add(f"{s}/attn/o_proj", quantizable=True)
    g.edge(av, o)
    return o


def _mla_subgraph(g: GraphSpec, s: str, entry: str) -> str:
    """DeepSeek-V3 latent attention: returns exit node name."""
    norm = g.add(f"{s}/attn_norm")
    g.edge(entry, norm)
    g.chain(norm, g.add(f"{s}/attn/q_a_proj", True), g.add(f"{s}/attn/q_norm"),
            g.add(f"{s}/attn/q_b_proj", True))
    g.chain(norm, g.add(f"{s}/attn/kv_a_proj", True),
            g.add(f"{s}/attn/kv_norm"), g.add(f"{s}/attn/kv_b_proj", True))
    qk = g.add(f"{s}/attn/qk_matmul", True)
    g.edge(f"{s}/attn/q_b_proj", qk)
    g.edge(f"{s}/attn/kv_b_proj", qk)
    sm = g.add(f"{s}/attn/softmax")
    g.edge(qk, sm)
    av = g.add(f"{s}/attn/av_matmul", True)
    g.edge(sm, av)
    g.edge(f"{s}/attn/kv_b_proj", av)
    o = g.add(f"{s}/attn/o_proj", True)
    g.edge(av, o)
    return o


def _mamba_subgraph(g: GraphSpec, s: str, entry: str) -> str:
    norm = g.add(f"{s}/attn_norm")  # the shared input norm's name in LM
    g.edge(entry, norm)
    return _mamba_shared_norm(g, s, norm)


def _mamba_shared_norm(g: GraphSpec, s: str, norm: str) -> str:
    """Mamba path when the input norm already exists (hybrid blocks)."""
    inp = g.add(f"{s}/mamba/in_proj", True)
    g.edge(norm, inp)
    conv = g.add(f"{s}/mamba/conv")
    g.edge(inp, conv)
    cb = g.add(f"{s}/mamba/cb_matmul", True)
    g.edge(conv, cb)
    ax = g.add(f"{s}/mamba/att_x_matmul", True)
    g.edge(cb, ax)
    g.edge(conv, ax)
    bx = g.add(f"{s}/mamba/bx_matmul", True)
    g.edge(conv, bx)
    cs = g.add(f"{s}/mamba/c_state_matmul", True)
    g.edge(bx, cs)
    g.edge(conv, cs)
    merge = g.add(f"{s}/mamba/merge")
    g.edge(ax, merge)
    g.edge(cs, merge)
    gate = g.add(f"{s}/mamba/gate_norm")
    g.edge(merge, gate)
    out = g.add(f"{s}/mamba/out_proj", True)
    g.edge(gate, out)
    return out


def _hybrid_subgraph(g: GraphSpec, s: str, entry: str) -> str:
    """Hymba: attention and mamba paths from one shared norm, merged."""
    norm = g.add(f"{s}/attn_norm")
    g.edge(entry, norm)
    o = _attn_shared_norm(g, s, norm)
    m_out = _mamba_shared_norm(g, s, norm)
    merge = g.add(f"{s}/hybrid_merge")
    g.edge(o, merge)
    g.edge(m_out, merge)
    return merge


_MIXERS = {"attn": _attn_subgraph, "mla": _mla_subgraph,
           "mamba": _mamba_subgraph, "hybrid": _hybrid_subgraph}


def _mlp_subgraph(g: GraphSpec, s: str, entry: str, activation: str,
                  scope: str = "mlp") -> str:
    norm = g.add(f"{s}/mlp_norm")
    g.edge(entry, norm)
    if activation == "swiglu":
        gate = g.add(f"{s}/{scope}/gate_proj", True)
        up = g.add(f"{s}/{scope}/up_proj", True)
        g.edge(norm, gate)
        g.edge(norm, up)
        mul = g.add(f"{s}/{scope}/glu_mul")
        g.edge(gate, mul)
        g.edge(up, mul)
        pre_down = mul
    else:
        up = g.add(f"{s}/{scope}/up_proj", True)
        g.edge(norm, up)
        act = g.add(f"{s}/{scope}/act")
        g.edge(up, act)
        pre_down = act
    down = g.add(f"{s}/{scope}/down_proj", True)
    g.edge(pre_down, down)
    return down


def _moe_subgraph(g: GraphSpec, s: str, entry: str, activation: str,
                  shared: bool) -> str:
    """Router, dispatch, expert GEMMs and combine; shared experts on a
    parallel path merged with the routed output. Returns the exit node."""
    norm = g.add(f"{s}/mlp_norm")
    g.edge(entry, norm)
    router = g.add(f"{s}/moe/router", True)
    g.edge(norm, router)
    disp = g.add(f"{s}/moe/dispatch")
    g.edge(router, disp)
    gate = g.add(f"{s}/moe/experts/gate_proj", True)
    up = g.add(f"{s}/moe/experts/up_proj", True)
    g.edge(disp, gate)
    g.edge(disp, up)
    mul = g.add(f"{s}/moe/glu_mul")
    g.edge(gate, mul)
    g.edge(up, mul)
    down = g.add(f"{s}/moe/experts/down_proj", True)
    g.edge(mul, down)
    comb = g.add(f"{s}/moe/combine")
    g.edge(down, comb)
    if not shared:
        return comb
    sh = _mlp_subgraph(g, f"{s}/moe", norm, activation, scope="shared")
    merge = g.add(f"{s}/moe/shared_merge")
    g.edge(comb, merge)
    g.edge(sh, merge)
    return merge


def build_lm_graph(cfg: LMConfig) -> GraphSpec:
    """The DAG of a decoder of attention, MLA, mamba and hybrid blocks, each
    with a dense MLP, an MoE layer or neither (no weights needed): one scope
    per layer, or per segment under ``scan_layers``."""
    g = GraphSpec()
    prev = g.add("embed")
    for s, (block, is_moe) in cfg.scopes():
        block_in = prev
        mix_out = _MIXERS[block](g, s, prev)
        add1 = g.add(f"{s}/residual_1")
        g.edge(mix_out, add1)
        g.edge(block_in, add1, residual=True)
        if is_moe:
            ffn_out = _moe_subgraph(g, s, add1, cfg.activation,
                                    cfg.moe.n_shared_experts > 0)
        elif cfg.d_ff > 0:
            ffn_out = _mlp_subgraph(g, s, add1, cfg.activation)
        else:
            prev = add1
            continue
        add2 = g.add(f"{s}/residual_2")
        g.edge(ffn_out, add2)
        g.edge(add1, add2, residual=True)
        prev = add2
    fn = g.add("final_norm")
    g.edge(prev, fn)
    head = g.add("lm_head", True)
    g.edge(fn, head)
    return g


def _residual(g: GraphSpec, name: str, out: str, block_in: str) -> str:
    add = g.add(name)
    g.edge(out, add)
    g.edge(block_in, add, residual=True)
    return add


def build_encdec_graph(cfg: EncDecConfig) -> GraphSpec:
    """The DAG of the encoder stack, then the decoder stack (the decoder
    embedding consumes the encoder output, which makes the two one
    sequence), each decoder layer's cross-attention a branch off
    ``cross_norm``."""
    g = GraphSpec()
    prev = g.add("frames")
    for i in range(cfg.n_enc_layers):
        s = f"enc/{i}"
        add1 = _residual(g, f"{s}/residual_1", _attn_subgraph(g, s, prev),
                         prev)
        prev = _residual(g, f"{s}/residual_2",
                         _mlp_subgraph(g, s, add1, cfg.activation), add1)
    enc_out = g.add("enc_final_norm")
    g.edge(prev, enc_out)
    prev = g.add("dec_embed")
    g.edge(enc_out, prev)
    for i in range(cfg.n_dec_layers):
        s = f"dec/{i}"
        add1 = _residual(g, f"{s}/residual_1", _attn_subgraph(g, s, prev),
                         prev)
        cn = g.add(f"{s}/cross_norm")
        g.edge(add1, cn)
        for proj in ("q_proj", "k_proj", "v_proj"):
            g.add(f"{s}/cross/{proj}", True)
            g.edge(cn, f"{s}/cross/{proj}")
        qk = g.add(f"{s}/cross/qk_matmul", True)
        g.edge(f"{s}/cross/q_proj", qk)
        g.edge(f"{s}/cross/k_proj", qk)
        smx = g.add(f"{s}/cross/softmax")
        g.edge(qk, smx)
        av = g.add(f"{s}/cross/av_matmul", True)
        g.edge(smx, av)
        g.edge(f"{s}/cross/v_proj", av)
        o2 = g.add(f"{s}/cross/o_proj", True)
        g.edge(av, o2)
        add_c = _residual(g, f"{s}/residual_cross", o2, add1)
        prev = _residual(g, f"{s}/residual_2",
                         _mlp_subgraph(g, s, add_c, cfg.activation), add_c)
    fn = g.add("dec_final_norm")
    g.edge(prev, fn)
    head = g.add("lm_head", True)
    g.edge(fn, head)
    return g


def build_graph(model) -> GraphSpec:
    if isinstance(model, EncDec):
        return build_encdec_graph(model.cfg)
    if isinstance(model, LM):
        return build_lm_graph(model.cfg)
    raise TypeError(type(model))
