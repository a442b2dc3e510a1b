from .streaming import (StreamingCodecDecoder, StreamingCodecEncoder, decode_lookback_frames,
                        encode_lookback)

__all__ = ["StreamingCodecDecoder", "StreamingCodecEncoder", "decode_lookback_frames",
           "encode_lookback"]
