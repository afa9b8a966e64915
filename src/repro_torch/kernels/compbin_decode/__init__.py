from repro_torch.kernels.compbin_decode.ops import (PACKED_STREAM_DECODERS,  # noqa: F401
                                                    STREAM_GRANULE_IDS,
                                                    compbin_decode,
                                                    decode_packed_stream,
                                                    packed_stream_decoder,
                                                    pad_packed_for_stream,
                                                    stream_bucket_ids)
from repro_torch.kernels.compbin_decode.ref import compbin_decode_ref  # noqa: F401
