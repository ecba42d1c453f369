from .preprocess import CodepointCorpus, clean_corpus
from .ngrams import NgramWindows, extract_windows, windows_as_sortable_keys
from .tfidf import DeviceEncodeSrc, EllMatrix, TfidfEncoder, ell_from_numpy

__all__ = [
    "CodepointCorpus",
    "clean_corpus",
    "NgramWindows",
    "extract_windows",
    "windows_as_sortable_keys",
    "DeviceEncodeSrc",
    "EllMatrix",
    "TfidfEncoder",
    "ell_from_numpy",
]
