"""Products a period that the QP build takes one batched GEMM a controller
over its lanes: the port's counter ``grouped_products``, its change over
each traced step, mean over the traced stretch; nothing where the port
keeps no such counter."""
from benchmark import spans


def read(ctx):
    return spans.counter(ctx, lambda s: s.get("grouped_products"))
