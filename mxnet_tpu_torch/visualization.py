"""Network visualization (parity: mxnet_tpu/visualization.py,
python/mxnet/visualization.py — print_summary, plot_network; the
latter needs the optional ``graphviz`` package, as in the JAX one)."""
from __future__ import annotations

from .base import MXNetError

__all__ = ["print_summary", "plot_network"]


def print_summary(symbol, shape=None, line_length=120, positions=(0.44, 0.64,
                                                                  0.74, 1.0)):
    show_shape = False
    shape_dict = {}
    if shape is not None:
        show_shape = True
        _, out_shapes, _ = symbol.get_internals().infer_shape(**shape)
        internals = symbol.get_internals()
        for (node, i), oshape in zip(internals._entries, out_shapes):
            key = node.name + ("_output%d" % i if node.num_outputs > 1
                               else "_output")
            shape_dict[key] = oshape
            shape_dict[node.name] = oshape

    positions = [int(line_length * p) for p in positions]
    to_display = ["Layer (type)", "Output Shape", "Param #", "Previous Layer"]

    def print_row(fields, positions):
        line = ""
        for i, field in enumerate(fields):
            line += str(field)
            line = line[: positions[i]]
            line += " " * (positions[i] - len(line))
        print(line)

    print("_" * line_length)
    print_row(to_display, positions)
    print("=" * line_length)
    total_params = [0]

    def print_layer_summary(node, out_shape):
        op = node.op or "null"
        pre_layers = [n.name for (n, _) in node.inputs if n.op is not None]
        cur_param = 0
        if op == "null" and (node.name.endswith("weight")
                             or node.name.endswith("bias")
                             or node.name.endswith("gamma")
                             or node.name.endswith("beta")):
            if node.name in shape_dict:
                cur_param = 1
                for d in shape_dict[node.name]:
                    cur_param *= d
        first_connection = "" if not pre_layers else pre_layers[0]
        fields = ["%s(%s)" % (node.name, op),
                  str(out_shape) if out_shape else "",
                  cur_param, first_connection]
        print_row(fields, positions)
        total_params[0] += cur_param

    for node in symbol._topo_nodes():
        key = node.name + "_output"
        print_layer_summary(node, shape_dict.get(key, shape_dict.get(node.name)))
        print("_" * line_length)
    print("Total params: %d" % total_params[0])
    print("_" * line_length)


def plot_network(symbol, title="plot", save_format="pdf", shape=None,
                 dtype=None, node_attrs=None, hide_weights=True):
    try:
        from graphviz import Digraph
    except ImportError:
        raise MXNetError("graphviz is not installed in this environment; "
                         "use print_summary instead") from None
    dot = Digraph(name=title)
    for node in symbol._topo_nodes():
        if hide_weights and node.op is None and node.name != "data":
            continue
        dot.node(str(id(node)), "%s\n%s" % (node.name, node.op or "var"))
        for (src, _) in node.inputs:
            if hide_weights and src.op is None and src.name != "data":
                continue
            dot.edge(str(id(src)), str(id(node)))
    return dot
