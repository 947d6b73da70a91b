from .base_wrapper_dataset import BaseWrapperDataset
from .bert_tokenize_dataset import BertTokenizeDataset, BertWordPieceTokenizer
from .dictionary import Dictionary
from .indexed_dataset import IndexedPickleDataset, make_builder
from .lru_cache_dataset import LRUCacheDataset
from .mask_tokens_dataset import MaskTokensDataset
from .nested_dictionary_dataset import NestedDictionaryDataset
from .pad_dataset import PadDataset, RightPadDataset, RightPadDataset2D
from .sort_dataset import EpochShuffleDataset
from .unicore_dataset import UnicoreDataset

__all__ = [
    "BaseWrapperDataset",
    "BertTokenizeDataset",
    "BertWordPieceTokenizer",
    "Dictionary",
    "EpochShuffleDataset",
    "IndexedPickleDataset",
    "LRUCacheDataset",
    "MaskTokensDataset",
    "NestedDictionaryDataset",
    "PadDataset",
    "RightPadDataset",
    "RightPadDataset2D",
    "UnicoreDataset",
    "make_builder",
]
