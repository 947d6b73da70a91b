from .dropout import DropoutRng
from .layer_norm import LayerNorm, RMSNorm, configure_fused_norm
from .multihead_attention import SelfMultiheadAttention
from .transformer_encoder import (
    TransformerEncoder,
    TransformerEncoderLayer,
    init_bert_params,
    make_rp_bucket,
    relative_position_bucket,
)

__all__ = [
    "DropoutRng",
    "LayerNorm",
    "RMSNorm",
    "SelfMultiheadAttention",
    "TransformerEncoder",
    "TransformerEncoderLayer",
    "configure_fused_norm",
    "init_bert_params",
    "make_rp_bucket",
    "relative_position_bucket",
]
