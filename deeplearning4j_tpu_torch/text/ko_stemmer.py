"""Korean eojeol analyzer: best-parse stem + josa/eomi decomposition.

Reference analog: deeplearning4j-nlp-korean — the twitter-korean-text
(open-korean-text) tokenizer/stemmer: each eojeol (space-delimited unit)
is decomposed into stem + particle/ending chains by scoring candidate
parses against noun/verb/josa/eomi dictionaries, and verbs/adjectives are
normalized to their dictionary form (stem + 다). This module implements
that design self-contained (the ``text/ja_lattice.py`` precedent):

1. **Candidate parses** of an eojeol: known noun (+ josa chain), a
   compound of known nouns (+ josa chain), a known verb/adjective stem +
   eomi (ending) chain covering the remainder exactly, or an unknown stem
   with a trailing josa. Common contractions un-contract first
   (했 = 하 + 였, 됐 = 되 + 었, 해 = 하 + 여 …).
2. **Scoring**: known whole words beat compounds beat unknown-stem
   strips; full suffix coverage is required for the verb parse — the
   tokenizer-scorer role of twitter-korean-text's ParsedChunk scoring.
3. **Normalization**: verb/adjective parses emit ``stem + 다`` (먹었어요
   → 먹다), noun parses emit the bare stem (학교에 → 학교) — the
   normalization that makes Korean embeddings usable without full
   morphology (the reference's signature behavior).

The bundled dictionaries are starter lexicons (golden-tested in
tests/test_text.py); the factory merges user lexicons as nouns.
"""

from __future__ import annotations

#: verb / adjective stems (dictionary form = stem + 다)
_VERB_STEMS = set(
    "하 가 오 보 주 받 먹 마시 자 일어나 앉 서 걷 뛰 달리 살 죽 "
    "읽 쓰 듣 말하 이야기하 생각하 공부하 일하 노래하 요리하 운동하 "
    "사랑하 좋아하 싫어하 시작하 계속하 준비하 연습하 연구하 학습하 "
    "훈련하 사용하 이용하 필요하 중요하 비슷하 따뜻하 깨끗하 조용하 "
    "만나 배우 가르치 알 모르 타 내리 열 닫 기다리 찾 사 팔 만들 "
    "되 있 없 계시 드리 고맙 감사하 미안하 죄송하 좋 나쁘 크 작 많 "
    "적 길 짧 높 낮 빠르 느리 예쁘 아름답 어렵 쉽 재미있 재미없 "
    "맛있 맛없 춥 덥 차갑 뜨겁 가 오 보이 들리 웃 울 입 벗 신 "
    "쉬 놀 일어서 돌아가 돌아오 들어가 들어오 나가 나오 올라가 "
    "내려가 지나가 건너 떠나 도착하 출발하 "
    # additional high-frequency verb/adjective stems (twitter-korean-text
    # ships a full dictionary; this is the same coverage direction)
    "얘기하 대답하 질문하 설명하 소개하 부탁하 약속하 거짓말하 "
    "인사하 축하하 걱정하 후회하 기억하 이해하 결정하 선택하 "
    "결혼하 이사하 여행하 구경하 쇼핑하 청소하 빨래하 세수하 "
    "목욕하 샤워하 산책하 데이트하 전화하 문자하 검색하 저장하 "
    "삭제하 다운로드하 입력하 클릭하 가입하 로그인하 주문하 "
    "예약하 계산하 취소하 확인하 신청하 제출하 발표하 토론하 "
    "졸업하 입학하 취직하 퇴근하 출근하 지각하 성공하 실패하 "
    "노력하 참석하 참가하 초대하 방문하 환영하 약하 강하 건강하 "
    "피곤하 심심하 행복하 불행하 슬프 기쁘 즐겁 괴롭 외롭 그립 "
    "무섭 부끄럽 부럽 귀엽 밉 고프 아프 바쁘 한가하 배고프 "
    "배부르 목마르 졸리 똑똑하 멍청하 부지런하 게으르 착하 "
    "친절하 무뚝뚝하 솔직하 정직하 용감하 유명하 신선하 편하 "
    "불편하 편리하 간단하 복잡하 특별하 이상하 심하 급하 "
    "늦 이르 멀 가깝 넓 좁 두껍 얇 무겁 가볍 밝 어둡 싸 비싸 "
    "새롭 낡 젊 늙 굵 가늘 깊 얕 둥글 곧 굽 마르 젖 시원하 "
    "따르 다르 같 틀리 맞 남 떠오르 모이 모으 바꾸 바뀌 고치 "
    "부서지 깨지 끊 끊어지 이기 지 빌리 빌려주 갚 벌 쓰이 "
    "보내 지내 견디 참 버리 줍 숨 숨기 잊 잊어버리 잃 잃어버리 "
    "얻 구하 지키 어기 밀 당기 던지 잡 놓 놓치 누르 돌리 돌 "
    "걸 걸리 풀 묶 싸우 화해하 안 업 끌 따라가 따라오 데려가 "
    "데려오 가져가 가져오 꺼내 넣 채우 비우 더하 빼 곱하 나누 "
    "세 재 달 낫 붓 짓 긋 눕 씻 익 태어나 자라 키우 가르 "
    "날 날아가 흐르 멈추 움직이 떨어지 떨어뜨리 올리 내리 "
    "늘 늘리 줄 줄이 오르 바라 바라보 쳐다보 살펴보 찾아보 "
    "물 물어보 알아보 알리 알려주 보여주 들려주 믿 의심하 "
    "느끼 원하 바꾸 권하 시키 말리 칭찬하 혼나 혼내 꾸짖 "
    "웃기 울리 즐기 심 캐 따 뽑 꽂 얼 녹 끓 끓이 굽 볶 튀기 "
    "무치 섞 자르 썰 다지 간 맛보 차리 치우 닦 쓸 털 걸레질하 "
    "다리 꿰매 짜 풀리 감 감기 빗 바르 지우 그리 색칠하 접 "
    "오리 붙 붙이 떼 쌓 허물 짚 기대 눕히 앉히 세우 태우 "
    "내려주 마중하 배웅하 헤어지 사귀 어울리 싫증나 질리 "
    "반하 빠지 취하 깨 깨우 꾸 설레 긴장하 떨 진정하 안심하 "
    "포기하 도전하 시도하 극복하 해결하 처리하 관리하 운영하 "
    "경영하 투자하 저축하 소비하 생산하 판매하 구매하 수출하 "
    "수입하 개발하 발전하 변하 변화하 증가하 감소하 향상되 "
    "개선되 발견하 발명하 실험하 분석하 조사하 측정하 기록하 "
    "비교하 평가하 판단하 증명하 주장하 반대하 찬성하 동의하 "
    "거절하 허락하 금지하 명령하 지시하 요구하 요청하 제안하 "
    "추천하 보고하 전하 전달하 퍼지 퍼뜨리 소문나".split())

#: verbal endings (eomi) — chains of up to 3 cover the conjugation space
_EOMI = set(
    "다 요 고 서 며 면 지 네 죠 니 나 게 어 아 여 은 는 을 ㄹ "
    "었 았 였 겠 시 으시 세 어요 아요 여요 에요 예요 어서 아서 "
    "여서 으면 다면 라면 지만 는데 은데 ㄴ데 니까 으니까 습니다 "
    "ㅂ니다 습니까 ㅂ니까 세요 으세요 십시오 자 읍시다 ㅂ시다 "
    "려고 으려고 러 으러 도록 든지 거나 기 음 ㅁ 는다 ㄴ다 "
    "었다 았다 였다 겠다 고있 고있다 어야 아야 여야".split())

#: explicit contraction rewrites (forms the jamo rules below can't reach)
_CONTRACTIONS = [
    ("했", "하였"), ("해", "하여"), ("됐", "되었"), ("돼", "되어"),
]

#: conjugated 이다-copula endings after a noun, longest first
#: (계획입니다 / 학생이에요 / 친구예요 / 사실이었습니다 ...)
_COPULA_ENDINGS = sorted(
    ("입니다", "입니까", "이에요", "예요", "이었습니다", "였습니다",
     "이었어요", "였어요", "이다", "이며", "이라서", "이라고", "라고",
     "인데", "이지만", "이니까", "일까요", "이겠지요"),
    key=len, reverse=True)

_MAX_EOMI_CHAIN = 3

# --- hangul jamo arithmetic for the general conjugation rules ----------
# syllable = 0xAC00 + (choseong*21 + jungseong)*28 + jongseong
_JONG_B = 17    # final ㅂ (습니다/ㅂ니다 merge: 하+ㅂ니다 -> 합니다)
_JONG_SS = 20   # final ㅆ (past-tense merge: 가+았 -> 갔, 먹+었 stays split)
_JUNG_A, _JUNG_O, _JUNG_EO, _JUNG_EU = 0, 8, 4, 18
#: vowel-merge stem alternates: surface vowel -> underlying stem vowel
#: (ㅓ<-ㅡ: 예뻐<-예쁘; ㅕ<-ㅣ: 마셔<-마시; ㅘ<-ㅗ: 봐<-보; ㅝ<-ㅜ: 줘<-주)
_VOWEL_ALT = {4: 18, 6: 20, 9: 8, 14: 13}


def _decompose(ch):
    o = ord(ch) - 0xAC00
    if 0 <= o < 11172:
        return o // 588, (o % 588) // 28, o % 28
    return None


def _compose(cho, jung, jong=0):
    return chr(0xAC00 + (cho * 21 + jung) * 28 + jong)


def _surface_variants(eojeol):
    """The eojeol plus un-contracted rewrites: explicit table entries and
    the two general jamo rules (ㅆ-final past tense, ㅂ-final formal)."""
    out = [eojeol]
    for contracted, expanded in _CONTRACTIONS:
        if contracted in eojeol:
            out.append(eojeol.replace(contracted, expanded, 1))
    for i, ch in enumerate(eojeol):
        d = _decompose(ch)
        if d is None:
            continue
        cho, jung, jong = d
        if jong == _JONG_SS:
            suff = "았" if jung in (_JUNG_A, _JUNG_O) else "었"
            out.append(eojeol[:i] + _compose(cho, jung) + suff
                       + eojeol[i + 1:])
        if jong == _JONG_B and eojeol[i + 1:i + 3] in ("니다", "니까",
                                                       "시다", "시오"):
            out.append(eojeol[:i] + _compose(cho, jung) + "ㅂ"
                       + eojeol[i + 1:])
    return out


def _stem_lookup(stem):
    """The dictionary stem for a surface stem, or None — resolves
    vowel-merged final syllables (예뻐 -> 예쁘, 마셔 -> 마시)."""
    if stem in _VERB_STEMS:
        return stem
    d = _decompose(stem[-1]) if stem else None
    if d and d[2] == 0 and d[1] in _VOWEL_ALT:
        alt = stem[:-1] + _compose(d[0], _VOWEL_ALT[d[1]])
        if alt in _VERB_STEMS:
            return alt
    return None


def _eomi_chain_covers(rest):
    """True if ``rest`` splits entirely into <= _MAX_EOMI_CHAIN endings."""
    if not rest:
        return True

    def rec(s, depth):
        if not s:
            return True
        if depth == 0:
            return False
        for ln in range(min(len(s), 4), 0, -1):
            if s[:ln] in _EOMI and rec(s[ln:], depth - 1):
                return True
        return False

    return rec(rest, _MAX_EOMI_CHAIN)


def _eomi_chain(rest):
    """The actual ending chain (for emit_suffixes), greedy-longest."""
    out = []
    while rest:
        for ln in range(min(len(rest), 4), 0, -1):
            if rest[:ln] in _EOMI:
                out.append(rest[:ln])
                rest = rest[ln:]
                break
        else:
            return None
    return out


def _verb_parse(eojeol):
    """(dict_stem, endings) for the best verb/adjective reading, or None.
    Prefers the longest known stem; tries contraction/jamo rewrites."""
    best = None
    for s in _surface_variants(eojeol):
        for split in range(len(s), 0, -1):
            stem = _stem_lookup(s[:split])
            rest = s[split:]
            if stem is not None and _eomi_chain_covers(rest):
                if best is None or len(stem) > len(best[0]):
                    best = (stem, _eomi_chain(rest) or [])
                break  # longest stem for this surface found
    return best


def _strip_josa(piece, josa_sorted, nouns=()):
    """(stem, josa_chain_string) stripping a CHAIN of particles, or None.

    Chain rule (학교에서는 -> 학교 + 에서 + 는): the outermost particle may
    be any length, but further strips take only multi-char particles or
    stop at a known noun — a single-char particle can only close the
    chain, which keeps lookalike noun endings (바나나) from unravelling."""
    stripped = []
    cur = piece
    for depth in range(3):
        if cur in nouns:
            break
        hit = None
        for josa in josa_sorted:
            if (len(cur) > len(josa) and cur.endswith(josa)
                    and (depth == 0 or len(josa) >= 2)):
                hit = josa
                break
        if hit is None:
            break
        stripped.append(hit)
        cur = cur[:-len(hit)]
    if not stripped:
        return None
    return cur, "".join(reversed(stripped))


def analyze_eojeol(eojeol, nouns, josa_sorted, *, max_word_len=8,
                   strip=True, emit_suffixes=False):
    """Best-parse token list for one eojeol.

    ``nouns``: known-noun set (factory lexicon). ``josa_sorted``: particle
    list, longest first. ``strip=False`` returns the eojeol raw (the
    reference factory's strip_josa=False contract)."""
    if not strip:
        return [eojeol]
    # 1. known word wins outright
    if eojeol in nouns:
        return [eojeol]
    candidates = []  # (score, tokens) — lowest score wins

    # 2. known noun + josa chain
    sj = _strip_josa(eojeol, josa_sorted, nouns)
    if sj and sj[0] in nouns:
        toks = [sj[0], sj[1]] if emit_suffixes else [sj[0]]
        candidates.append((1, toks))

    # 3. verb/adjective stem + eomi chain -> dictionary form stem+다
    vp = _verb_parse(eojeol)
    if vp:
        stem, endings = vp
        toks = [stem + "다"]
        if emit_suffixes:
            toks += endings
        candidates.append((2, toks))

    # 3b. noun + 이다-copula conjugation (계획입니다 -> 계획): the copula
    # conjugates like a verb but attaches to a noun, so it is stripped
    # like an ending chain — open-korean-text's Noun+Josa(이다) pattern
    for cop in _COPULA_ENDINGS:
        if eojeol.endswith(cop) and len(eojeol) > len(cop):
            body2 = eojeol[:-len(cop)]
            toks = [body2, cop] if emit_suffixes else [body2]
            candidates.append((1.5 if body2 in nouns else 2.5, toks))
            break

    # 4. compound of known nouns (each piece known), optional trailing josa
    body, tail = eojeol, None
    if sj:
        body, tail = sj
    pieces = _max_match(body, nouns, max_word_len)
    if len(pieces) > 1 and all(p in nouns for p in pieces):
        toks = list(pieces)
        if tail and emit_suffixes:
            toks.append(tail)
        candidates.append((3 if tail else 3.5, toks))

    # 5. unknown stem + trailing josa
    if sj and len(sj[0]) >= 1:
        toks = [sj[0], sj[1]] if emit_suffixes else [sj[0]]
        candidates.append((4, toks))

    if not candidates:
        return [eojeol]
    candidates.sort(key=lambda c: c[0])
    return candidates[0][1]


def _max_match(run, lexicon, max_word_len):
    from deeplearning4j_tpu_torch.text.languages import max_match
    return max_match(run, lexicon, max_word_len)
