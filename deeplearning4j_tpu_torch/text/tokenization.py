"""Tokenizer interfaces.

Reference analog: text/tokenization/ in the reference's deeplearning4j-nlp
module — TokenizerFactory SPI (DefaultTokenizerFactory,
NGramTokenizerFactory) with pluggable TokenPreProcess. Language packs
(chinese/japanese/korean/uima) are factories of the same interface; here the
SPI accepts any callable, so external tokenizers plug in the same way.
"""

from __future__ import annotations

import re


class TokenPreProcess:
    def pre_process(self, token: str) -> str:
        return token


class CommonPreprocessor(TokenPreProcess):
    """Lowercase + strip punctuation/digits (reference: CommonPreprocessor)."""

    _PUNCT = re.compile(r"[\d\.,:;!?\"'()\[\]{}<>/\\|@#$%^&*+=~`-]+")

    def pre_process(self, token):
        return self._PUNCT.sub("", token.lower())


class Tokenizer:
    def __init__(self, tokens):
        self._tokens = list(tokens)
        self._pos = 0

    def has_more_tokens(self):
        return self._pos < len(self._tokens)

    def next_token(self):
        t = self._tokens[self._pos]
        self._pos += 1
        return t

    def get_tokens(self):
        return list(self._tokens)

    def count_tokens(self):
        return len(self._tokens)


class DefaultTokenizerFactory:
    """Whitespace/regex word tokenizer (reference: DefaultTokenizerFactory)."""

    _WORD = re.compile(r"\S+")

    def __init__(self, preprocessor: TokenPreProcess | None = None):
        self.preprocessor = preprocessor

    def create(self, text: str) -> Tokenizer:
        tokens = self._WORD.findall(text)
        if self.preprocessor is not None:
            tokens = [self.preprocessor.pre_process(t) for t in tokens]
            tokens = [t for t in tokens if t]
        return Tokenizer(tokens)


class NGramTokenizerFactory:
    """Word n-grams (reference: NGramTokenizerFactory)."""

    def __init__(self, n_min=1, n_max=2, preprocessor=None):
        self.n_min, self.n_max = n_min, n_max
        self.base = DefaultTokenizerFactory(preprocessor)

    def create(self, text: str) -> Tokenizer:
        words = self.base.create(text).get_tokens()
        grams = []
        for n in range(self.n_min, self.n_max + 1):
            for i in range(len(words) - n + 1):
                grams.append(" ".join(words[i:i + n]))
        return Tokenizer(grams)


def default_tokenizer_factory():
    """The default factory every SequenceVectors front door shares
    (reference: Word2Vec.Builder's DefaultTokenizerFactory +
    CommonPreprocessor default)."""
    return DefaultTokenizerFactory(CommonPreprocessor())


class StemmingPreprocessor(CommonPreprocessor):
    """CommonPreprocessor + English stemming (reference:
    deeplearning4j-nlp-uima StemmingPreprocessor.java, which runs a
    Snowball ``EnglishStemmer`` after the common cleanup; here the stemmer
    is a self-contained Porter implementation — the algorithm Snowball's
    English stemmer extends)."""

    _VOWELS = set("aeiou")

    # Porter steps 2 and 3 run SEQUENTIALLY (a step-2 output like
    # 'hopeful' must still lose its 'ful' in step 3 so 'hopefulness'
    # and 'hopeful' collapse to the same stem)
    _STEP2 = (("ational", "ate"), ("tional", "tion"), ("iveness", "ive"),
              ("fulness", "ful"), ("ousness", "ous"), ("ization", "ize"),
              ("biliti", "ble"), ("entli", "ent"), ("ation", "ate"),
              ("alism", "al"), ("aliti", "al"), ("iviti", "ive"),
              ("ousli", "ous"), ("izer", "ize"), ("alli", "al"),
              ("ator", "ate"), ("eli", "e"))
    _STEP3 = (("icate", "ic"), ("ative", ""), ("alize", "al"),
              ("iciti", "ic"), ("ical", "ic"), ("ful", ""), ("ness", ""))

    def _forms(self, w):
        """C/V classification, one iterative left-to-right pass ('y' is a
        consonant at position 0 or after a vowel)."""
        out = []
        prev_cons = False
        for i, ch in enumerate(w):
            if ch in self._VOWELS:
                cons = False
            elif ch == "y":
                cons = i == 0 or not prev_cons
            else:
                cons = True
            out.append("C" if cons else "V")
            prev_cons = cons
        return out

    def _measure(self, w):
        """Porter's m: number of VC sequences in the word."""
        forms = self._forms(w)
        return sum(1 for i in range(len(forms) - 1)
                   if forms[i] == "V" and forms[i + 1] == "C")

    def _has_vowel(self, w):
        return "V" in self._forms(w)

    def _ends_double_cons(self, w):
        return (len(w) >= 2 and w[-1] == w[-2]
                and self._forms(w)[-1] == "C")

    def _cvc(self, w):
        if len(w) < 3:
            return False
        f = self._forms(w)
        return (f[-3] == "C" and f[-2] == "V" and f[-1] == "C"
                and w[-1] not in "wxy")

    def _map_suffixes(self, w, table):
        for suf, rep in table:
            if w.endswith(suf) and self._measure(w[:-len(suf)]) > 0:
                return w[:-len(suf)] + rep
        return w

    def stem(self, w):
        if len(w) <= 2:
            return w
        # step 1a
        for suf, rep in (("sses", "ss"), ("ies", "i"), ("ss", "ss"),
                         ("s", "")):
            if w.endswith(suf):
                w = w[:-len(suf)] + rep
                break
        # step 1b
        if w.endswith("eed"):
            if self._measure(w[:-3]) > 0:
                w = w[:-1]
        else:
            hit = None
            for suf in ("ed", "ing"):
                if w.endswith(suf) and self._has_vowel(w[:-len(suf)]):
                    hit = w[:-len(suf)]
                    break
            if hit is not None:
                w = hit
                if w.endswith(("at", "bl", "iz")):
                    w += "e"
                elif self._ends_double_cons(w) and w[-1] not in "lsz":
                    w = w[:-1]
                elif self._measure(w) == 1 and self._cvc(w):
                    w += "e"
        # step 1c
        if w.endswith("y") and self._has_vowel(w[:-1]):
            w = w[:-1] + "i"
        # steps 2 then 3
        w = self._map_suffixes(w, self._STEP2)
        w = self._map_suffixes(w, self._STEP3)
        # step 4 (drop residual suffixes at m > 1)
        for suf in ("ement", "ance", "ence", "able", "ible", "ment",
                    "ant", "ent", "ism", "ate", "iti", "ous", "ive",
                    "ize", "ion", "al", "er", "ic", "ou"):
            if w.endswith(suf):
                stem = w[:-len(suf)]
                if self._measure(stem) > 1 and (
                        suf != "ion" or (stem and stem[-1] in "st")):
                    w = stem
                break
        # step 5
        if w.endswith("e"):
            m = self._measure(w[:-1])
            if m > 1 or (m == 1 and not self._cvc(w[:-1])):
                w = w[:-1]
        if self._measure(w) > 1 and self._ends_double_cons(w) \
                and w.endswith("l"):
            w = w[:-1]
        return w

    def pre_process(self, token):
        token = super().pre_process(token)
        return self.stem(token) if token else token


class UimaTokenizerFactory(DefaultTokenizerFactory):
    """Sentence-annotation-driven tokenization (reference:
    deeplearning4j-nlp-uima UimaTokenizerFactory.java — a UIMA
    AnalysisEngine runs SentenceAnnotator + TokenizerAnnotator; here the
    sentence annotator is languages.split_sentences and tokens come from
    the standard tokenizer, preserving sentence order)."""

    def create(self, text):
        from deeplearning4j_tpu_torch.text.languages import split_sentences
        tokens = []
        for sent in split_sentences(text):
            tokens.extend(super().create(sent).get_tokens())
        return Tokenizer(tokens)
