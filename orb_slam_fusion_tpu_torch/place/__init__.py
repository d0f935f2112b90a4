"""Place recognition: binary vocabularies and the keyframe database.

Counterpart of ``orb_slam_fusion_tpu/place/``: the flat seeded codebook
(``vocabulary``), the DBoW2-style tree vocabulary (``tree_vocabulary``,
with its text and binary formats) and the dense keyframe database
(``database``). Descriptors are int32 bit patterns, as everywhere in the
port.
"""

from .vocabulary import (  # noqa: F401
    BinaryVocabulary, make_vocabulary, quantize, bow_vector)
from .tree_vocabulary import (  # noqa: F401
    TreeVocabulary, train_vocabulary, quantize_tree, bow_vector_tree,
    load_tree_text, save_tree_text, load_tree_binary, save_tree_binary)
from .database import KeyFrameDatabase  # noqa: F401
