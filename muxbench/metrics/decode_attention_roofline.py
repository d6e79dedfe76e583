"""The decode-attention calls' least time at the card's peaks, over the
device time of the kernels that ran them (torch.profiler, by name).

The least time of a call is the larger of its bytes (each row's kv_len
key and value rows read once, the queries and the output) over 3.35 TB/s
and its operations over the bf16 peak, from its shapes (the step's `work`,
by kernel name, from the configuration's reference module), summed over
every layer's call in the online steps of the traced stretch.
It counts the call's work, whatever implements it; the kernels are the
port's `decode_partial` and, where a call splits the keys, its
`decode_combine`."""
NAMES = ("decode_partial", "decode_combine")


def read(rd):
    tr = rd.trace
    if not tr:
        return None
    device_s = sum(s for n, s in tr["kernels"].items()
                   if any(k in n for k in NAMES))
    least_s = sum(s.work["least_s"].get("decode_attention", 0.0)
                  for s in rd.rec.spans if s.kind == "online" and s.traced)
    if device_s <= 0 or least_s <= 0:
        return None
    return 100.0 * least_s / device_s
