"""Feed-forward neural network as an expression graph, copied from
``heyoka_tpu.models.ffnn`` (reference: ``src/model/ffnn.cpp``,
``include/heyoka/model/ffnn.hpp:98-124``).

Weights and biases follow the reference's flattened convention
(``ffnn.cpp:76-78``): all weight matrices first, layer by layer in row-major
(out x in) order, then all bias vectors layer by layer —
``[W01, W12, ..., B1, B2, ...]``.  By default they are runtime params
(``par[i]``), so a parameter vector trained elsewhere ports directly; pass
``nn_wb`` to embed explicit values (floats or expressions) instead — that is
how the thermoNET density models bake in their trained weights.

This is the neural-ODE building block: the returned expressions drop
straight into an ODE right-hand side.
"""

from __future__ import annotations

from typing import Callable, Sequence

from ..expr.core import Param, expr, sum_expr


def ffnn_par_count(n_in: int, nn_hidden: Sequence[int], n_out: int) -> int:
    sizes = [int(n_in)] + [int(h) for h in nn_hidden] + [int(n_out)]
    return sum(
        sizes[i] * sizes[i + 1] + sizes[i + 1] for i in range(len(sizes) - 1)
    )


def ffnn(
    inputs: Sequence,
    nn_hidden: Sequence[int],
    n_out: int,
    activations: Sequence[Callable],
    *,
    nn_wb=None,
    first_par_idx: int = 0,
):
    """Build the symbolic outputs of a fully connected net.

    ``activations`` has one callable per layer (hidden layers + output
    layer), each mapping Expr -> Expr (e.g. ``heyoka_tpu.tanh``; use
    ``lambda e: e`` for linear).  ``nn_wb``: optional explicit
    weights+biases in the flattened reference layout.
    """
    ins = [expr(i) for i in inputs]
    sizes = [len(ins)] + [int(h) for h in nn_hidden] + [int(n_out)]
    if len(activations) != len(sizes) - 1:
        raise ValueError(
            f"need {len(sizes) - 1} activations (hidden + output), "
            f"got {len(activations)}"
        )

    n_w = sum(sizes[i] * sizes[i + 1] for i in range(len(sizes) - 1))
    n_wb = n_w + sum(sizes[1:])
    if nn_wb is not None:
        nn_wb = [expr(v) for v in nn_wb]
        if len(nn_wb) != n_wb:
            raise ValueError(
                f"nn_wb must have {n_wb} entries, got {len(nn_wb)}"
            )
        get = lambda k: nn_wb[k]  # noqa: E731
    else:
        base = int(first_par_idx)
        get = lambda k: Param(base + k)  # noqa: E731

    wcounter = 0
    bcounter = n_w
    layer = ins
    for li in range(len(sizes) - 1):
        n_in, n_o = sizes[li], sizes[li + 1]
        act = activations[li]
        out = []
        for o in range(n_o):
            terms = [get(wcounter + o * n_in + i) * layer[i] for i in range(n_in)]
            terms.append(get(bcounter + o))
            out.append(act(sum_expr(terms)))
        wcounter += n_in * n_o
        bcounter += n_o
        layer = out
    return layer
