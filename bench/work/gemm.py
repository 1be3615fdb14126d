"""Work of one ``ops.matmul(a, b, trans_b=...)`` call: 2MNK operations;
each operand read once and the output written once."""


def count(ctx, args, kwargs):
    a, b = args[0], args[1]
    M, K = a.shape
    N = b.shape[0] if kwargs.get("trans_b", False) else b.shape[1]
    return 2.0 * M * N * K, float((M * K + K * N + M * N) * a.element_size())
