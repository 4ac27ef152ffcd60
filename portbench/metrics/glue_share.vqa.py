"""glue_share.vqa (device trace): the share of the slice's device time
spent outside the port's hand-written kernels (xlxmert_tpu_torch/csrc):
LayerNorms, gelu, adds, casts, the embedding and catalog gathers,
box_fc, the pooler, the answers' copy."""

from portbench.lib.reduce import PORT_KERNELS


def read(rec):
    tr = rec.trace
    if tr is None:
        return None
    total = tr.device_s()
    return 100.0 * (total - tr.device_s(PORT_KERNELS)) / total
