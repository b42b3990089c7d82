"""Language-pack tokenizer factories: Chinese, Japanese, Korean (+ sentence
segmentation, the uima-pack role).

Reference analog: the deeplearning4j-nlp-{chinese,japanese,korean,uima}
modules (SURVEY.md §2.6) — ChineseTokenizerFactory (ansj segmenter),
JapaneseTokenizerFactory (kuromoji morphological analyzer),
KoreanTokenizerFactory (twitter-korean-text), UimaTokenizerFactory
(sentence/token annotators). Those wrap ~20k LoC of third-party segmenter
code; here the factories implement the same ``create(text) -> Tokenizer``
SPI with self-contained segmentation:

* dictionary-driven maximum-matching over an EMBEDDED starter lexicon of
  high-frequency words (extensible/replaceable with a user lexicon) — the
  standard CJK segmentation baseline the heavyweight libraries refine;
* script-aware fallback: unmatched Han characters tokenize per character
  (the n-gram-friendly default), kana/hangul runs follow per-language rules;
* Japanese: okurigana attachment (a short hiragana tail after a kanji run
  joins the kanji token, e.g. 食べ), hiragana runs split on common
  particles (は/が/を/に/で/と/も/の/から/まで/...);
* Korean: josa (particle) stripping from eojeol ends (은/는/이/가/을/를/
  에/의/로/...), emitting the stem — twitter-korean-text's signature
  normalization;
* ``split_sentences``: multi-script rule-based sentence segmentation
  (。！？.!? + closing quotes), the uima SentenceAnnotator role.

The factories plug into everything SequenceVectors-based (Word2Vec,
ParagraphVectors, TF-IDF) exactly like the reference's language packs plug
into SequenceVectors' TokenizerFactory slot.
"""

from __future__ import annotations

import unicodedata

from deeplearning4j_tpu_torch.text.tokenization import Tokenizer

# ---------------------------------------------------------------------------
# embedded starter lexicons: high-frequency words. Deliberately small —
# enough to beat the per-character baseline on common text; production use
# supplies a domain lexicon via the factory argument.
# ---------------------------------------------------------------------------

_ZH_LEXICON = (
    "我们 你们 他们 她们 这个 那个 什么 怎么 为什么 因为 所以 但是 可是 "
    "如果 虽然 然后 现在 时候 今天 明天 昨天 已经 还是 就是 不是 没有 "
    "可以 应该 需要 知道 觉得 喜欢 工作 学习 学校 老师 学生 朋友 时间 "
    "问题 地方 国家 中国 世界 大家 东西 事情 孩子 先生 小姐 谢谢 再见 "
    "电脑 手机 网络 数据 模型 训练 机器 学习 人工 智能").split()

_JA_LEXICON = (
    "これ それ あれ どれ ここ そこ どこ わたし あなた 私たち 日本 東京 "
    "学校 先生 学生 友達 時間 問題 仕事 今日 明日 昨日 食べる 飲む 行く "
    "来る 見る 聞く 話す 読む 書く 思う 言う ありがとう こんにちは "
    "さようなら データ モデル 学習 機械").split()

_KO_LEXICON = (
    "우리 너희 그들 이것 그것 저것 여기 거기 어디 무엇 언제 누구 왜 "
    "어떻게 오늘 내일 어제 시간 문제 일 학교 선생님 학생 친구 한국 "
    "서울 세계 사람 아이 감사합니다 안녕하세요 데이터 모델 학습 기계 "
    # people / family / society
    "나 저 당신 남자 여자 어른 아기 가족 부모 부모님 아버지 어머니 "
    "아빠 엄마 형 누나 오빠 언니 동생 아들 딸 할아버지 할머니 이름 "
    "생일 결혼 사랑 마음 생각 느낌 꿈 희망 약속 이야기 말 말씀 소리 "
    "목소리 웃음 눈물 얼굴 눈 코 입 귀 머리 손 발 팔 다리 몸 건강 "
    # time / calendar
    "지금 아침 점심 저녁 밤 낮 오전 오후 요일 월요일 화요일 수요일 "
    "목요일 금요일 토요일 일요일 주말 평일 휴일 올해 작년 내년 달 "
    "주 날 날짜 계절 봄 여름 가을 겨울 날씨 비 눈 바람 구름 하늘 "
    # places / travel
    "집 방 부엌 화장실 문 창문 마당 길 거리 동네 도시 시골 나라 "
    "고향 회사 사무실 공장 가게 시장 마트 백화점 식당 카페 은행 "
    "병원 약국 우체국 도서관 공원 극장 영화관 박물관 역 정류장 "
    "공항 호텔 바다 강 산 섬 북한 미국 중국 일본 영국 부산 인천 "
    "대구 대전 광주 지하철 버스 기차 택시 자동차 자전거 비행기 배 "
    "표 지도 여행 길거리 "
    # school / work / study
    "공부 수업 교실 숙제 시험 질문 대답 책 공책 연필 볼펜 종이 "
    "사전 신문 잡지 소설 글 글자 한글 영어 한국어 일본어 중국어 "
    "외국어 단어 문장 뜻 의미 번역 발음 문법 역사 과학 수학 음악 "
    "미술 체육 대학 대학교 교수 박사 전공 졸업 입학 취직 직업 "
    "회의 보고 보고서 계획 목표 결과 이유 방법 준비 연습 경험 "
    "실력 능력 성공 실패 노력 기회 책임 "
    # food / daily life
    "밥 물 차 커피 우유 주스 맥주 술 빵 과일 사과 배 포도 수박 "
    "바나나 채소 고기 소고기 돼지고기 닭고기 생선 계란 김치 국 "
    "찌개 라면 국수 떡 과자 사탕 설탕 소금 맛 아침밥 점심밥 저녁밥 "
    "요리 음식 식사 메뉴 그릇 접시 컵 숟가락 젓가락 옷 바지 치마 "
    "셔츠 신발 양말 모자 안경 가방 지갑 우산 시계 선물 돈 값 가격 "
    "전화 전화번호 핸드폰 휴대폰 컴퓨터 노트북 인터넷 이메일 사진 "
    "영화 노래 춤 그림 운동 축구 야구 농구 수영 등산 산책 쇼핑 "
    "청소 빨래 목욕 샤워 잠 침대 의자 책상 텔레비전 냉장고 에어컨 "
    # abstract / misc
    "것 수 때 곳 분 년 월 일월 이월 삼월 앞 뒤 위 아래 안 밖 옆 "
    "사이 가운데 근처 오른쪽 왼쪽 동쪽 서쪽 남쪽 북쪽 처음 마지막 "
    "다음 이번 저번 전 후 중 모두 전부 일부 반 정도 크기 모양 색 "
    "색깔 종류 번호 숫자 나이 키 무게 속도 온도 소식 뉴스 정보 "
    "사실 거짓말 인생 삶 죽음 전쟁 평화 자유 정부 법 경찰 군인 "
    "의사 간호사 요리사 가수 배우 작가 기자 운전사 손님 주인 "
    "이웃 인기 취미 재미 걱정 고민 스트레스 기분 행복 슬픔 화 "
    "용기 힘 도움 인사 축하 칭찬 사과문 질서 규칙 문화 전통 종교 "
    "예술 기술 경제 정치 사회 환경 자연 동물 식물 개 고양이 새 "
    "물고기 소 돼지 닭 꽃 나무 풀 잎 열매 씨 해 달 별 땅 "
    "불 공기 돌 흙 금 은 유리 플라스틱 프로그램 게임 시스템 "
    "네트워크 파일 화면 키보드 마우스 버튼 비밀번호 회원 가입 "
    "웹사이트 블로그 댓글 동영상 방송 광고 기사 "
    # adverbs — listed whole so the josa stripper never unravels them
    # (많이 is NOT 많+이)
    "많이 빨리 천천히 일찍 늦게 같이 함께 혼자 열심히 자주 가끔 "
    "항상 언제나 늘 벌써 아직 이미 곧 방금 바로 먼저 나중에 "
    "정말 진짜 아주 매우 너무 조금 좀 더 덜 가장 제일 잘 못 안 "
    "다시 또 계속 갑자기 천천 아마 물론 특히 역시 그냥 거의 "
    "별로 전혀 서로 모두 다 약간 꽤 상당히 완전히 확실히 "
    "그리고 그러나 하지만 그래서 그러면 그런데 그래도 또는 "
    "즉 만약 비록").split()

#: common Korean particles (josa), longest first for greedy suffix matching
_KO_JOSA = sorted(
    ("은", "는", "이", "가", "을", "를", "에", "의", "와", "과", "도", "만",
     "로", "으로", "에서", "에게", "한테", "께서", "부터", "까지", "보다",
     "처럼", "마다", "조차", "밖에", "이나", "나", "라도", "든지",
     # chain-closers and formal/instrumental/comitative variants
     "께", "이라도", "으로서", "로서", "으로써", "로써", "이며", "이랑",
     "랑", "에게서", "한테서", "에다", "이든지", "이라는",
     "라는", "이란", "란", "야말로", "이야말로"),
    key=len, reverse=True)

#: common Japanese particles used to split long hiragana runs
_JA_PARTICLES = sorted(
    ("は", "が", "を", "に", "で", "と", "も", "の", "へ", "や", "から",
     "まで", "より", "ので", "のに", "けど", "でも", "だけ", "など", "ね",
     "よ", "か"), key=len, reverse=True)


def _char_class(ch):
    o = ord(ch)
    if 0x4E00 <= o <= 0x9FFF or 0x3400 <= o <= 0x4DBF or 0xF900 <= o <= 0xFAFF:
        return "han"
    if 0x3040 <= o <= 0x309F:
        return "hiragana"
    if 0x30A0 <= o <= 0x30FF or 0x31F0 <= o <= 0x31FF:
        return "katakana"
    if 0xAC00 <= o <= 0xD7AF or 0x1100 <= o <= 0x11FF or 0x3130 <= o <= 0x318F:
        return "hangul"
    if ch.isspace():
        return "space"
    if ch.isalnum():
        return "word"
    return "punct"


def _script_runs(text):
    runs = []
    cur, cls = "", None
    for ch in text:
        c = _char_class(ch)
        if c == cls:
            cur += ch
        else:
            if cur:
                runs.append((cur, cls))
            cur, cls = ch, c
    if cur:
        runs.append((cur, cls))
    return runs


_SENT_END = set("。！？．.!?")
_SENT_TRAIL = set("」』）)\"'”’")


def split_sentences(text):
    """Rule-based sentence segmentation across scripts (reference: the uima
    pack's SentenceAnnotator role): break after 。！？.!?, keeping trailing
    closing quotes/brackets with the finished sentence."""
    out, cur = [], ""
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        cur += ch
        if ch in _SENT_END:
            # abbreviation guard for latin '.': next char lowercase/digit
            if ch == "." and i + 1 < n and (text[i + 1].isalnum()):
                i += 1
                continue
            while i + 1 < n and text[i + 1] in _SENT_TRAIL:
                cur += text[i + 1]
                i += 1
            s = cur.strip()
            if s:
                out.append(s)
            cur = ""
        i += 1
    s = cur.strip()
    if s:
        out.append(s)
    return out


def max_match(run, lexicon, max_word_len):
    """Greedy forward maximum matching against the lexicon; unmatched
    characters become single-char tokens (the classical CJK baseline)."""
    out, i, n = [], 0, len(run)
    while i < n:
        for ln in range(min(max_word_len, n - i), 1, -1):
            if run[i:i + ln] in lexicon:
                out.append(run[i:i + ln])
                i += ln
                break
        else:
            out.append(run[i])
            i += 1
    return out


class _CjkTokenizerFactoryBase:
    """Shared CJK factory: lexicon maximum-matching + script-run rules."""

    #: scripts whose runs are segmented (vs kept whole)
    per_char_scripts = ("han",)
    #: scripts dropped from output
    drop = ("space", "punct")
    #: built-in starter lexicon (merged under a user-supplied one)
    default_lexicon = ()

    def __init__(self, lexicon=None, preprocessor=None, max_word_len=8,
                 use_default_lexicon=True):
        self.lexicon = set(self.default_lexicon) if use_default_lexicon \
            else set()
        if lexicon:
            self.lexicon |= set(lexicon)
        self.preprocessor = preprocessor
        self.max_word_len = max_word_len

    def _segment_run(self, run, cls):
        if cls not in self.per_char_scripts:
            return [run]
        if self.lexicon:
            return self._max_match(run)
        return list(run)

    def _max_match(self, run):
        return max_match(run, self.lexicon, self.max_word_len)

    def _lattice_create(self, text, tokens):
        """Shared lattice-mode tail: drop-filter + preprocessor + wrap."""
        tokens = [t for t in tokens if _char_class(t[0]) not in self.drop]
        if self.preprocessor is not None:
            tokens = [self.preprocessor.pre_process(t) for t in tokens]
            tokens = [t for t in tokens if t]
        return Tokenizer(tokens)

    def _runs(self, text):
        return _script_runs(unicodedata.normalize("NFKC", text))

    def create(self, text: str) -> Tokenizer:
        tokens = []
        for run, cls in self._runs(text):
            if cls in self.drop:
                continue
            tokens.extend(self._segment_run(run, cls))
        if self.preprocessor is not None:
            tokens = [self.preprocessor.pre_process(t) for t in tokens]
            tokens = [t for t in tokens if t]
        return Tokenizer(tokens)


class ChineseTokenizerFactory(_CjkTokenizerFactoryBase):
    """Reference: deeplearning4j-nlp-chinese ChineseTokenizerFactory (ansj).

    Default mode="lattice" runs the Viterbi lattice segmenter
    (text/zh_lattice.py — dictionary + rule candidates incl. the ansj
    person-name invocation + connection-cost Viterbi, the ansj design
    self-contained). mode="maxmatch" keeps the greedy lexicon
    maximum-matching baseline (per-character fallback without a lexicon).
    """

    per_char_scripts = ("han",)
    default_lexicon = _ZH_LEXICON

    def __init__(self, lexicon=None, preprocessor=None, max_word_len=8,
                 mode="lattice", use_default_lexicon=True,
                 merge_num_quantifier=False):
        super().__init__(lexicon=lexicon, preprocessor=preprocessor,
                         max_word_len=max_word_len,
                         use_default_lexicon=use_default_lexicon)
        if mode not in ("lattice", "maxmatch"):
            raise ValueError(f"unknown mode {mode!r}")
        #: ansj's optional NumRecognition (数量词合并): numeral + measure
        #: word fuse into one token — a lattice-path feature (the merge
        #: uses the Viterbi classes), so a maxmatch factory can't honor it
        if merge_num_quantifier and (mode != "lattice"
                                     or not use_default_lexicon):
            raise ValueError("merge_num_quantifier requires the lattice "
                             "mode (with its bundled dictionary)")
        self.merge_num_quantifier = merge_num_quantifier
        # same contract as the Japanese factory: without its bundled
        # dictionary a lattice cannot run, so that request means maxmatch
        self.mode = mode if use_default_lexicon else "maxmatch"
        from deeplearning4j_tpu_torch.text import zh_lattice
        # merge the user lexicon into the lattice dictionary ONCE (create()
        # runs per document in SequenceVectors loops)
        self._merged = zh_lattice.merge_entries(set(lexicon)
                                                if lexicon else None)

    def create(self, text: str) -> Tokenizer:
        if self.mode == "lattice":
            from deeplearning4j_tpu_torch.text import zh_lattice
            return self._lattice_create(
                text, zh_lattice.tokenize(
                    text, merged=self._merged,
                    merge_num_quantifier=self.merge_num_quantifier))
        return super().create(text)


class JapaneseTokenizerFactory(_CjkTokenizerFactoryBase):
    """Reference: deeplearning4j-nlp-japanese JapaneseTokenizerFactory
    (kuromoji). Default mode="lattice" runs the Viterbi lattice
    morphological analyzer (text/ja_lattice.py — dictionary + unknown-word
    invocation + connection-cost Viterbi, the kuromoji design
    self-contained). mode="maxmatch" keeps the round-2 heuristic:

    * a short hiragana tail (<=2 chars) directly after a kanji run attaches
      to the kanji token (okurigana: 食べ, 思い);
    * longer hiragana runs split on common particles;
    * katakana runs (loanwords) stay whole; the lexicon refines everything.
    """

    per_char_scripts = ("han", "hiragana", "katakana")
    default_lexicon = _JA_LEXICON

    OKURIGANA_MAX = 2

    def __init__(self, lexicon=None, preprocessor=None, max_word_len=8,
                 mode="lattice", use_default_lexicon=True,
                 lattice_mode="normal", user_dict_path=None):
        super().__init__(lexicon=lexicon, preprocessor=preprocessor,
                         max_word_len=max_word_len,
                         use_default_lexicon=use_default_lexicon)
        if mode not in ("lattice", "maxmatch"):
            raise ValueError(f"unknown mode {mode!r}")
        if lattice_mode not in ("normal", "search"):
            raise ValueError(f"unknown lattice_mode {lattice_mode!r}")
        # kuromoji Mode.NORMAL vs Mode.SEARCH (decompounding for indexing)
        self.lattice_mode = lattice_mode
        if lattice_mode == "search" and (mode != "lattice"
                                         or not use_default_lexicon):
            # maxmatch never consults lattice_mode: silently returning
            # undecompounded tokens would betray the caller's request
            raise ValueError(
                "lattice_mode='search' requires mode='lattice' with the "
                "default lexicon (the maxmatch path has no search mode)")
        # lexicon-free segmentation (use_default_lexicon=False) is
        # inherently the heuristic path — a lattice without its bundled
        # dictionary cannot run, so that request selects maxmatch mode
        # (where max_word_len / self.lexicon keep their round-2 contract)
        self.mode = mode if use_default_lexicon else "maxmatch"
        # user-supplied words feed the lattice as mid-cost noun entries,
        # merged into the dictionary ONCE (create() runs per document)
        from deeplearning4j_tpu_torch.text import ja_lattice
        self._merged = ja_lattice.merge_entries(set(lexicon)
                                                if lexicon else None)
        # kuromoji user-dictionary CSV (surface,custom segmentation,...):
        # matching surfaces are force-segmented ahead of the lattice
        if user_dict_path and self.mode != "lattice":
            raise ValueError(
                "user_dict_path requires mode='lattice' (maxmatch never "
                "consults the user dictionary)")
        self._user_dict = (ja_lattice.UserDictionary.load(user_dict_path)
                           if user_dict_path else None)

    def create(self, text: str) -> Tokenizer:
        if self.mode == "lattice":
            from deeplearning4j_tpu_torch.text import ja_lattice
            return self._lattice_create(
                text, ja_lattice.tokenize(text, merged=self._merged,
                                          mode=self.lattice_mode,
                                          user_dict=self._user_dict))
        return self._create_maxmatch(text)

    def _create_maxmatch(self, text: str) -> Tokenizer:
        runs = self._runs(text)
        tokens = []
        i = 0
        while i < len(runs):
            run, cls = runs[i]
            if cls in self.drop:
                i += 1
                continue
            if (cls == "han" and i + 1 < len(runs)
                    and runs[i + 1][1] == "hiragana"
                    and len(runs[i + 1][0]) <= self.OKURIGANA_MAX
                    and runs[i + 1][0] not in _JA_PARTICLES):
                # kanji + short okurigana = one token (e.g. 食べ) — but a
                # bare particle after kanji (肉を) is a boundary, not a tail
                tokens.append(run + runs[i + 1][0])
                i += 2
                continue
            tokens.extend(self._segment_run(run, cls))
            i += 1
        if self.preprocessor is not None:
            tokens = [self.preprocessor.pre_process(t) for t in tokens]
            tokens = [t for t in tokens if t]
        return Tokenizer(tokens)

    def _segment_run(self, run, cls):
        if cls == "katakana":
            return [run]
        if cls == "hiragana":
            return self._split_particles(run)
        if cls == "han":
            if self.lexicon:
                return self._max_match(run)
            return list(run)
        return [run]

    def _split_particles(self, run):
        """Lexicon max-match first; then peel common particles greedily."""
        if self.lexicon:
            pieces = self._max_match(run)
        else:
            pieces = [run]
        out = []
        for piece in pieces:
            if len(piece) == 1 or piece in self.lexicon:
                out.append(piece)
                continue
            i, n = 0, len(piece)
            while i < n:
                for p in _JA_PARTICLES:
                    if piece.startswith(p, i):
                        out.append(p)
                        i += len(p)
                        break
                else:
                    # consume until the next particle boundary
                    j = i + 1
                    while j < n and not any(piece.startswith(p, j)
                                            for p in _JA_PARTICLES):
                        j += 1
                    out.append(piece[i:j])
                    i = j
        return out


#: loanword sub-nouns for morpheme-mode decompounding. twitter-korean-text
#: splits compounds its dictionary lacks into known sub-nouns (딥러닝 ->
#: 딥|러닝 in the reference's own KoreanTokenizerTest) while dictionary
#: compounds stay whole (오픈소스). This table plays its sub-noun
#: dictionary's role; grow it as coverage needs grow.
_KO_LOANWORD_SUBS = frozenset(
    "딥 러닝 소스 코드 베이스 프레임 워크 소프트 웨어 하드 "
    "라이브러리 오픈소스 클라우드 컴퓨팅 모바일 서비스 플랫폼 "
    "인터페이스 알고리즘 서버 클라이언트 데이터".split())


class KoreanTokenizerFactory(_CjkTokenizerFactoryBase):
    """Reference: deeplearning4j-nlp-korean KoreanTokenizerFactory
    (twitter-korean-text). Hangul runs are eojeol (space-delimited); each
    eojeol max-matches the lexicon, then common trailing particles (josa)
    are stripped so '학교에' and '학교는' normalize to '학교' — the
    behavior that makes Korean embeddings usable without full morphology.

    ``morpheme=True`` matches twitter-korean-text's morpheme granularity
    — the exact token stream the reference pack's own KoreanTokenizerTest
    asserts (tests/test_cjk_heldout.py consumes it in place): josa emitted
    as tokens, unknown loanword compounds decompounded by the sub-noun
    table (딥러닝 -> 딥|러닝), and the formal copula's final 다 split off
    (입니다 -> 입니|다)."""

    per_char_scripts = ("hangul",)
    default_lexicon = _KO_LEXICON

    def __init__(self, lexicon=None, preprocessor=None, max_word_len=8,
                 use_default_lexicon=True, strip_josa=True,
                 emit_josa=False, morpheme=False):
        super().__init__(lexicon, preprocessor, max_word_len,
                         use_default_lexicon)
        self.morpheme = morpheme
        self.strip_josa = strip_josa  # with emit on, strip SPLITS the josa
        self.emit_josa = emit_josa or morpheme

    def _segment_run(self, run, cls):
        if cls != "hangul":
            return [run]
        from deeplearning4j_tpu_torch.text import ko_stemmer
        toks = ko_stemmer.analyze_eojeol(
            run, self.lexicon, _KO_JOSA, max_word_len=self.max_word_len,
            strip=self.strip_josa, emit_suffixes=self.emit_josa)
        if not self.morpheme:
            return toks
        out = []
        for t in toks:
            out.extend(self._morpheme_split(t))
        return out

    def _morpheme_split(self, tok):
        # formal copula / polite endings: the final 다 is its own morpheme
        # (reference KoreanTokenizerTest: 라이브러리입니다 -> ... 입니|다)
        if tok.endswith("니다") and len(tok) >= 3:
            for stem_end in ("입니", "습니"):
                if tok.endswith(stem_end + "다"):
                    head = tok[:-3]
                    return ([*self._morpheme_split(head)] if head else []) \
                        + [stem_end, "다"]
            # contracted ㅂ니다 endings (갑니다): the ㅂ fuses into the
            # preceding syllable's jongseong, so the closest surface
            # split keeps the fused stem and frees the final 다
            return [tok[:-1], "다"]
        if tok in self.lexicon or tok in _KO_LOANWORD_SUBS:
            return [tok]
        parts = self._decompound(tok)
        return parts if parts is not None else [tok]

    def _decompound(self, tok):
        """Greedy longest-match split over lexicon + sub-noun table;
        None unless the whole token is covered by >= 2 known parts."""
        vocab = _KO_LOANWORD_SUBS
        parts, i, n = [], 0, len(tok)
        while i < n:
            for ln in range(min(self.max_word_len, n - i), 0, -1):
                piece = tok[i:i + ln]
                if piece in vocab or piece in self.lexicon:
                    parts.append(piece)
                    i += ln
                    break
            else:
                return None
        return parts if len(parts) >= 2 else None
