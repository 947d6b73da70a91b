from .base_wrapper_dataset import BaseWrapperDataset
from .bert_tokenize_dataset import BertTokenizeDataset, BertWordPieceTokenizer
from .dictionary import Dictionary
from .indexed_dataset import IndexedPickleDataset, make_builder
from .lru_cache_dataset import LRUCacheDataset
from .mask_tokens_dataset import MaskTokensDataset
from .misc_datasets import (AppendTokenDataset, FromNumpyDataset, NumelDataset,
                            NumSamplesDataset, PrependTokenDataset, RawArrayDataset,
                            RawLabelDataset, RawNumpyDataset, TokenizeDataset,
                            default_collate)
from .nested_dictionary_dataset import NestedDictionaryDataset
from .pad_dataset import PadDataset, RightPadDataset, RightPadDataset2D
from .sort_dataset import EpochShuffleDataset
from .unicore_dataset import UnicoreDataset

__all__ = [
    "AppendTokenDataset",
    "BaseWrapperDataset",
    "BertTokenizeDataset",
    "BertWordPieceTokenizer",
    "Dictionary",
    "EpochShuffleDataset",
    "FromNumpyDataset",
    "IndexedPickleDataset",
    "LRUCacheDataset",
    "MaskTokensDataset",
    "NestedDictionaryDataset",
    "NumSamplesDataset",
    "NumelDataset",
    "PadDataset",
    "PrependTokenDataset",
    "RawArrayDataset",
    "RawLabelDataset",
    "RawNumpyDataset",
    "RightPadDataset",
    "RightPadDataset2D",
    "TokenizeDataset",
    "UnicoreDataset",
    "default_collate",
    "make_builder",
]
