"""One SASRec training step's model operations (forward and backward at
three times the forward's products), f32.

* blocks: per layer and position, the q/k/v, output and two FFN products,
  24·d² operations, at every position: the pads' keys and values enter the
  real positions' attention;
* attention: per layer the two causal products, 2·b·t²·d (half of t × t);
* logits: 2·d·n_items a position whose target counts in the loss, and only
  there: the other positions' logits change nothing.

The softmax, norms and the optimizer are left out (a few operations an
element)."""


def flops(batch: int, t: int, d: int, n_layers: int, n_items: int, loss_positions: int) -> float:
    blocks = n_layers * 24.0 * batch * t * d * d
    attention = n_layers * 2.0 * batch * t * t * d
    logits = 2.0 * loss_positions * d * n_items
    return 3.0 * (blocks + attention + logits)
