from deeplearning4j_tpu_torch.text.tokenization import (  # noqa: F401
    DefaultTokenizerFactory, NGramTokenizerFactory, StemmingPreprocessor,
    UimaTokenizerFactory)
from deeplearning4j_tpu_torch.text.languages import (  # noqa: F401
    ChineseTokenizerFactory, JapaneseTokenizerFactory, KoreanTokenizerFactory,
)
from deeplearning4j_tpu_torch.text.corpus import (  # noqa: F401
    AggregatingSentenceIterator, AsyncLabelAwareIterator,
    BasicLabelAwareIterator, BasicLineIterator, CollectionSentenceIterator,
    FileLabelAwareIterator, FileSentenceIterator,
    FilenamesLabelAwareIterator, LabelAwareIterator, LabelledDocument,
    LabelsSource, LineSentenceIterator, MultipleEpochsSentenceIterator,
    PrefetchingSentenceIterator, SentenceIterator,
    SimpleLabelAwareIterator, StreamLineIterator,
    SynchronizedSentenceIterator)
from deeplearning4j_tpu_torch.text.vocab import VocabCache, VocabConstructor, huffman_encode  # noqa: F401
from deeplearning4j_tpu_torch.text.word2vec import SequenceVectors, Word2Vec  # noqa: F401
from deeplearning4j_tpu_torch.text.paragraph_vectors import ParagraphVectors  # noqa: F401
from deeplearning4j_tpu_torch.text.glove import GloVe  # noqa: F401
from deeplearning4j_tpu_torch.text.serializer import (  # noqa: F401
    StaticWordVectors, load_word2vec_binary, load_word_vectors,
    save_word2vec_binary, save_word_vectors)
from deeplearning4j_tpu_torch.text.bow import BagOfWordsVectorizer, TfidfVectorizer  # noqa: F401
