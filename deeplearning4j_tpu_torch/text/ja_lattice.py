"""Lattice-based Japanese morphological tokenizer (Viterbi).

Reference analog: deeplearning4j-nlp-japanese — the kuromoji tokenizer
(~55 files wrapping the kuromoji lattice analyzer: dictionary lookup over
a trie, unknown-word invocation by character class, and a Viterbi search
over (word cost + connection cost)). This module implements the same
three-stage design self-contained:

1. **Dictionary lookup**: every substring (bounded length) from each
   position is matched against an embedded dictionary of surface forms,
   each carrying a word cost and a connection class (noun / verb-stem /
   particle / auxiliary / ...). Verb/adjective conjugation is handled the
   kuromoji way — stems are dictionary entries and endings are AUX/INFL
   entries, so 食べました lattices as 食べ + まし + た.
2. **Unknown-word invocation**: positions where the dictionary has no (or
   few) candidates spawn unknown tokens from the maximal same-script run
   (whole katakana/latin/digit runs — loanwords and numbers; short kanji
   pieces; single hiragana), with length-penalized costs, mirroring
   kuromoji's char.def/unk.def behavior.
3. **Viterbi**: dynamic programming over (position, connection class)
   minimizing total word+connection cost; backtrack yields the token
   sequence. The connection matrix is a compact class-pair table (e.g.
   particle-after-noun cheap, particle-after-particle expensive) — the
   1000x1000 kuromoji matrix's role at class granularity.

The bundled dictionary is a starter lexicon: a few hundred high-frequency
forms chosen to segment everyday text correctly (accuracy-tested against
curated goldens in tests/test_text.py); production use merges a domain
dictionary via ``user_entries``.
"""

from __future__ import annotations

import re
import unicodedata

# connection classes
NOUN, VERB, INFL, PART, AUX, ADJ, ADV, PRE, SUF, SYM, UNK = range(11)

_CLS_NAMES = ["noun", "verb", "infl", "part", "aux", "adj", "adv",
              "prefix", "suffix", "sym", "unk"]


def _build_dictionary():
    d: dict[str, list[tuple[int, int]]] = {}

    def add(words, cls, cost):
        for w in words.split():
            entries = d.setdefault(w, [])
            for i, (c0, k0) in enumerate(entries):
                if k0 == cls:  # same class listed twice: keep the cheaper
                    # cost (identical to what Viterbi's min would pick)
                    entries[i] = (min(c0, cost), cls)
                    break
            else:
                entries.append((cost, cls))

    def add_te(words, cost):
        """Te-form rows also register the matching ta-form (past): the
        euphonic stem is identical, only the final て/で flips to た/だ —
        kuromoji's dictionary lists both conjugated rows the same way."""
        add(words, VERB, cost)
        ta = " ".join(w[:-1] + ("た" if w[-1] == "て" else "だ")
                      for w in words.split())
        add(ta, VERB, cost)

    # --- nouns (common + domain) ---
    add("私 僕 君 彼 彼女 誰 何 人 方 物 事 所 時 日 年 月 週 分 秒 国 "
        "水 火 木 金 土 山 川 海 空 雨 雪 風 花 犬 猫 鳥 魚 本 車 道 駅 "
        "家 店 町 村 市 都 県 区 駅 朝 昼 夜 晩 今 前 後 中 外 上 下 左 右",
        NOUN, 3000)
    add("学校 先生 学生 友達 時間 問題 仕事 会社 電話 電車 自転車 飛行機 "
        "日本 東京 大阪 京都 世界 言葉 名前 写真 音楽 映画 料理 野菜 果物 "
        "天気 季節 春 夏 秋 冬 今日 明日 昨日 今年 去年 来年 毎日 毎週 "
        "午前 午後 最近 将来 未来 過去 歴史 文化 社会 経済 政治 科学 技術 "
        "機械 学習 研究 開発 情報 計算 言語 文章 単語 意味 結果 方法 理由 "
        "目的 必要 大切 大事 簡単 複雑 自分 自身 皆さん 子供 大人 男性 女性 "
        "家族 両親 父 母 兄 弟 姉 妹 息子 娘", NOUN, 2500)
    add("こと もの ところ とき ため よう そう はず わけ つもり", NOUN, 3200)
    add("これ それ あれ どれ ここ そこ あそこ どこ こちら そちら あちら "
        "どちら この その あの どの", NOUN, 2600)
    # --- verb stems (masu-stem & dictionary forms both listed) ---
    add("食べ 飲み 行き 来 見 聞き 話し 読み 書き 思い 言い 使い 作り "
        "入り 出 会い 買い 売り 立ち 座り 歩き 走り 泳ぎ 飛び 寝 起き "
        "働き 休み 遊び 学び 教え 覚え 忘れ 始め 終わり 開け 閉め 待ち "
        "持ち 取り 置き 帰り 送り 受け 続け 変わり 変え 考え 感じ 分かり "
        "でき 知り 住み 死に 生まれ 訓練し 勉強し 研究し 仕事し", VERB, 2800)
    add("食べる 飲む 行く 来る 見る 聞く 話す 読む 書く 思う 言う 使う "
        "作る 入る 出る 会う 買う 売る 立つ 座る 歩く 走る 泳ぐ 飛ぶ "
        "寝る 起きる 働く 休む 遊ぶ 学ぶ 教える 覚える 忘れる 始める "
        "終わる 開ける 閉める 待つ 持つ 取る 置く 帰る 送る 受ける "
        "続ける 変わる 変える 考える 感じる 分かる できる 知る 住む "
        "死ぬ 生まれる する いる ある なる 訓練する 勉強する", VERB, 2700)
    # --- te-forms (euphonic changes make them unreachable as stem+ending;
    # kuromoji's dictionary lists them as conjugated entries too) ---
    add_te("食べて 飲んで 行って 来て 見て 聞いて 話して 読んで 書いて "
        "思って 言って 使って 作って 入って 出て 会って 買って 売って "
        "立って 座って 歩いて 走って 泳いで 飛んで 寝て 起きて 働いて "
        "休んで 遊んで 学んで 教えて 覚えて 忘れて 始めて 終わって "
        "開けて 閉めて 待って 持って 取って 置いて 帰って 送って 受けて "
        "続けて 変わって 変えて 考えて 感じて 分かって できて 知って "
        "住んで 死んで 生まれて して なって", 2600)
    # --- inflection endings / auxiliaries after verb stems ---
    add("ます ました ません ませんでした まして たい たく たかった "
        "ない なかった なくて られる られた れる れた させる させた "
        "ている ていた ています ていました てある ておく てみる "
        "います いました いません ある あります ありました "
        "ば れば よう", INFL, 1500)
    add("た て で だ な い く", INFL, 2200)
    # --- copula / sentence-final auxiliaries ---
    add("です でした でしょう だ だった だろう である ではない "
        "じゃない かもしれない", AUX, 1600)
    # --- particles ---
    add("は が を に へ と も の で や か ね よ わ ぞ さ から まで "
        "より だけ しか ばかり など について として による ための "
        "けど けれど けれども しかし でも そして また ただ つまり", PART, 1000)
    # --- adjectives ---
    add("大きい 小さい 高い 安い 低い 新しい 古い 良い 悪い 早い 遅い "
        "近い 遠い 強い 弱い 長い 短い 広い 狭い 暑い 寒い 暖かい 涼しい "
        "楽しい 嬉しい 悲しい 難しい 易しい 面白い 美しい おいしい "
        "きれい 静か 元気 有名 便利 大丈夫 いい よい", ADJ, 2700)
    # i-adjective conjugated rows (〜かった past, 〜くて te-form): the
    # euphonic stem+ending split cannot reach them, same as verb te/ta
    # rows — kuromoji lists conjugated adjective rows in the dictionary
    add("よかった よくて 大きかった 小さかった 高かった 安かった "
        "新しかった 古かった 悪かった 早かった 遅かった 近かった "
        "遠かった 強かった 弱かった 長かった 短かった 広かった "
        "狭かった 暑かった 寒かった 暖かかった 涼しかった 楽しかった "
        "嬉しかった 悲しかった 難しかった 面白かった 美しかった "
        "おいしかった 忙しかった 眠かった 痛かった 怖かった "
        "可愛かった すごかった ひどかった 大きくて 小さくて 高くて "
        "安くて 新しくて 古くて 良くて 悪くて 早くて 遅くて 強くて "
        "長くて 短くて 広くて 暑くて 寒くて 楽しくて 嬉しくて "
        "悲しくて 難しくて 面白くて 美しくて おいしくて 忙しくて",
        ADJ, 2600)
    # --- adverbs ---
    add("とても すごく もっと 一番 少し ちょっと たくさん いつも 時々 "
        "もう まだ すぐ ゆっくり きっと たぶん 全然 絶対 本当に やはり "
        "やっぱり", ADV, 2600)
    # --- prefixes / suffixes ---
    add("お ご", PRE, 2900)
    add("さん くん ちゃん 様 的 性 化 者 員 長 家 学 語 人 国 円 歳 回 "
        "個 本 枚 匹 台 冊 度", SUF, 2400)
    # --- greetings / set phrases (kept whole) ---
    add("ありがとう ありがとうございます こんにちは こんばんは おはよう "
        "さようなら すみません お願いします はじめまして", NOUN, 1800)
    # --- katakana tech nouns ---
    add("データ モデル コンピュータ ネットワーク システム プログラム "
        "ソフトウェア インターネット テスト ニュース ゲーム", NOUN, 2400)
    # --- numerals and counters (kuromoji lists numerals as nouns and
    # counters as suffixes; the counter after a numeral binds cheaply
    # through the noun→suffix connection) ---
    add("一 二 三 四 五 六 七 八 九 十 百 千 万 億 兆 零 "
        "一つ 二つ 三つ 四つ 五つ 六つ 七つ 八つ 九つ "
        "一人 二人 三人 数人 何人 一度 今度 何度 一緒 半分 全部 一部",
        NOUN, 2300)
    add("時 時半 分 秒 日間 週間 ヶ月 か月 年間 番 番目 名 件 点 階 "
        "頭 杯 足 着 軒 通 曲 話", SUF, 2400)
    # --- time / calendar nouns ---
    add("月曜日 火曜日 水曜日 木曜日 金曜日 土曜日 日曜日 週末 平日 "
        "休日 祝日 誕生日 正月 夕方 深夜 早朝 今朝 今晩 先週 来週 "
        "先月 来月 毎朝 毎晩 毎年 時代 瞬間 期間 予定 締切", NOUN, 2400)
    # --- people / body / everyday nouns ---
    add("頭 顔 目 耳 鼻 口 手 足 腕 指 背 腰 心 体 声 涙 笑顔 "
        "赤 青 白 黒 緑 黄色 茶色 紫 色 "
        "朝食 昼食 夕食 朝ご飯 昼ご飯 晩ご飯 ご飯 パン 肉 魚介 卵 "
        "牛乳 茶 お茶 コーヒー 紅茶 酒 ビール 水道 料金 "
        "部屋 台所 風呂 トイレ 窓 扉 壁 床 天井 庭 鍵 机 椅子 棚 "
        "服 靴 帽子 傘 鞄 財布 眼鏡 時計 手紙 切手 封筒 荷物 "
        "病気 風邪 熱 薬 病院 医者 看護師 警察 消防 銀行 郵便局 "
        "図書館 公園 美術館 博物館 映画館 空港 港 橋 信号 交差点 "
        "地図 切符 乗り物 地下鉄 新幹線 バス タクシー 船 "
        "質問 答え 宿題 試験 授業 教室 黒板 辞書 雑誌 新聞 小説 物語 "
        "趣味 旅行 散歩 買い物 掃除 洗濯 運動 練習 試合 選手 "
        "お金 値段 給料 売上 利益 会議 資料 報告 連絡 相談 約束 "
        "関係 影響 状況 状態 環境 条件 基準 水準 程度 割合 平均 "
        "部分 全体 中心 周り 辺り 向こう 隣 間 奥 表 裏 横 角 "
        "種類 形 大きさ 長さ 重さ 高さ 深さ 広さ 速さ 強さ", NOUN, 2500)
    # --- more proper / regional nouns ---
    add("北海道 東北 関東 関西 九州 沖縄 横浜 名古屋 福岡 神戸 札幌 "
        "仙台 広島 奈良 青森 岩手 秋田 山形 福島 新潟 長野 静岡 岡山 "
        "熊本 鹿児島 千葉 埼玉 中国 韓国 台湾 アメリカ イギリス フランス "
        "ドイツ イタリア スペイン ロシア インド 英語 日本語 中国語 "
        "韓国語 フランス語 ドイツ語", NOUN, 2400)
    # --- common Japanese surnames + famous literary names (ipadic's
    # person-name entries; the zh lattice has a surname RULE, Japanese
    # name readings are too irregular for one — dictionary entries are
    # the kuromoji way) ---
    add("田中 鈴木 佐藤 高橋 伊藤 渡辺 山本 中村 小林 加藤 吉田 山田 "
        "佐々木 松本 井上 木村 清水 斎藤 阿部 森 池田 橋本 石川 山口 "
        "前田 藤田 小川 岡田 長谷川 村上 近藤 石井 遠藤 青木 坂本 "
        "夏目 漱石 芥川 龍之介 太宰 治 川端 康成 三島 由紀夫 "
        "村上春樹 宮崎 黒澤", NOUN, 2400)
    # --- more verb stems + dictionary + te/ta forms (same three-row
    # pattern as the core set: euphonic te/ta forms are dictionary
    # entries because stem+ending cannot reach them) ---
    add("歌い 踊り 笑い 泣き 怒り 驚き 喜び 悲しみ 急ぎ 止まり 止め "
        "動き 動かし 押し 引き 投げ 打ち 蹴り 運び 渡り 渡し 登り "
        "降り 乗り 落ち 落とし 拾い 捨て 集め 集まり 選び 決め 決まり "
        "調べ 探し 見つけ 見せ 示し 伝え 届け 頼み 助け 手伝い 守り "
        "払い 借り 貸し 返し 戻り 戻し 進み 進め 直し 治り 壊れ 壊し "
        "切り 切れ 折り 曲げ 伸び 伸ばし 増え 増やし 減り 減らし "
        "残り 残し 消え 消し 付き 付け 外し 合い 合わせ 比べ 並び "
        "並べ 積み 重ね 混ぜ 触り 握り 撮り 写し 描き 塗り 磨き "
        "洗い 拭き 乾かし 温め 冷やし 焼き 煮 蒸し 揚げ 炒め 切望し "
        "説明し 紹介し 案内し 準備し 用意し 確認し 報告し 連絡し "
        "相談し 参加し 出席し 欠席し 出発し 到着し 帰国し 入学し "
        "卒業し 就職し 結婚し 離婚し 成功し 失敗し 練習し 運動し "
        "掃除し 洗濯し 料理し 買い物し 旅行し 散歩し 心配し 安心し "
        "賛成し 反対し 約束し 注意し 利用し 使用し 活用し 予約し "
        "注文し 販売し 生産し 製造し 輸入し 輸出し 発表し 発見し "
        "発明し 開発し 実験し 分析し 評価し 判断し 決定し 選択し "
        "比較し 計算し 測定し 記録し 登録し 保存し 削除し 更新し "
        "検索し 翻訳し 入力し 出力し 実行し 処理し 管理し 運営し",
        VERB, 2800)
    add("歌う 踊る 笑う 泣く 怒る 驚く 喜ぶ 急ぐ 止まる 止める 動く "
        "動かす 押す 引く 投げる 打つ 蹴る 運ぶ 渡る 渡す 登る 降りる "
        "乗る 落ちる 落とす 拾う 捨てる 集める 集まる 選ぶ 決める "
        "決まる 調べる 探す 見つける 見せる 示す 伝える 届ける 頼む "
        "助ける 手伝う 守る 払う 借りる 貸す 返す 戻る 戻す 進む "
        "進める 直す 治る 壊れる 壊す 切る 切れる 折る 曲げる 伸びる "
        "伸ばす 増える 増やす 減る 減らす 残る 残す 消える 消す 付く "
        "付ける 外す 合う 合わせる 比べる 並ぶ 並べる 積む 重ねる "
        "混ぜる 触る 握る 撮る 写す 描く 塗る 磨く 洗う 拭く 乾かす "
        "温める 冷やす 焼く 煮る 蒸す 揚げる 炒める 思い出す 思いつく "
        "見える 聞こえる 笑える 泣ける もらう くれる あげる やる "
        "いただく くださる 差し上げる おっしゃる いらっしゃる 申す "
        "伺う 参る 拝見する 存じる", VERB, 2700)
    add_te("歌って 踊って 笑って 泣いて 怒って 驚いて 喜んで 急いで "
        "止まって 止めて 動いて 動かして 押して 引いて 投げて 打って "
        "蹴って 運んで 渡って 渡して 登って 降りて 乗って 落ちて "
        "落として 拾って 捨てて 集めて 集まって 選んで 決めて 決まって "
        "調べて 探して 見つけて 見せて 示して 伝えて 届けて 頼んで "
        "助けて 手伝って 守って 払って 借りて 貸して 返して 戻って "
        "戻して 進んで 進めて 直して 治って 壊れて 壊して 切って "
        "切れて 折って 曲げて 伸びて 伸ばして 増えて 増やして 減って "
        "減らして 残って 残して 消えて 消して 付いて 付けて 外して "
        "合って 合わせて 比べて 並んで 並べて 積んで 重ねて 混ぜて "
        "触って 握って 撮って 写して 描いて 塗って 磨いて 洗って "
        "拭いて 乾かして 温めて 冷やして 焼いて 煮て 蒸して 揚げて "
        "炒めて もらって くれて あげて やって いただいて "
        "降って 晴れて 曇って 咲いて 吹いて 鳴いて 光って 流れて "
        "始まって 通って 向かって 続いて 過ぎて 慣れて 疲れて "
        "遅れて 間に合って 気をつけて 頑張って", 2600)
    add("晴れ 曇り 咲き 吹き 鳴き 光り 流れ 始まり 通り 向かい "
        "続き 過ぎ 慣れ 疲れ 遅れ 間に合い 頑張り", VERB, 2800)
    add("降る 晴れる 曇る 咲く 吹く 鳴く 光る 流れる 始まる 通る "
        "向かう 続く 過ぎる 慣れる 疲れる 遅れる 間に合う 頑張る",
        VERB, 2700)
    # --- more i-adjectives + na-adjectives ---
    add("明るい 暗い 重い 軽い 太い 細い 厚い 薄い 深い 浅い 多い "
        "少ない 若い 危ない 忙しい 眠い 痛い 甘い 辛い 苦い 酸っぱい "
        "塩辛い 温かい 冷たい 熱い ぬるい 優しい 厳しい 正しい "
        "珍しい 懐かしい 恥ずかしい 羨ましい 恐ろしい 怖い 汚い "
        "美味しい まずい 可愛い 格好いい 素晴らしい ひどい すごい "
        "丸い 四角い 鋭い 鈍い 硬い 柔らかい", ADJ, 2700)
    add("好き 嫌い 上手 下手 得意 苦手 丁寧 親切 真面目 熱心 素直 "
        "正直 立派 豊か 貧しい 幸せ 不幸 安全 危険 自由 不便 複雑 "
        "単純 特別 普通 変 同じ 別 大変 無理 可能 不可能 必要 不要 "
        "十分 不足 新鮮 清潔 快適 適当 正確 確か 曖昧 明確 重要 "
        "主要 基本的 具体的 抽象的 積極的 消極的 自動的 効果的 "
        "代表的 一般的 個人的 国際的 伝統的 現代的 科学的 経済的",
        ADJ, 2600)
    # --- more adverbs / conjunctions ---
    add("必ず 多分 おそらく もちろん 例えば 特に 主に 約 ほぼ やっと "
        "ついに 既に もはや 突然 急に 次第に 徐々に だんだん どんどん "
        "しっかり はっきり ちゃんと きちんと のんびり ぐっすり "
        "そろそろ まず 次に 最後に 最初に 実は 実際 確かに 当然 "
        "残念ながら 幸い なぜ どうして どう こう ああ なぜなら "
        "それで だから ですから したがって ところが ところで さて "
        "それでも それなら すると もし もしも たとえ", ADV, 2600)
    # --- more katakana loanwords ---
    add("アプリ サイト メール パソコン スマホ ケータイ キーボード "
        "マウス ファイル フォルダ サーバ サーバー クラウド ウェブ "
        "ブラウザ パスワード ログイン ダウンロード アップロード "
        "インストール アップデート バージョン エラー バグ コード "
        "アルゴリズム ライブラリ フレームワーク オープンソース "
        "ホテル レストラン カフェ コンビニ スーパー デパート ビル "
        "エレベーター エスカレーター ドア テーブル ソファ ベッド "
        "テレビ ラジオ カメラ ビデオ スポーツ サッカー テニス "
        "バスケットボール プール ジム チーム メンバー グループ "
        "クラス レベル ポイント ルール マナー チャンス プレゼント "
        "パーティー イベント スケジュール プラン アイデア イメージ "
        "デザイン カラー サイズ タイプ スタイル バランス エネルギー "
        "ストレス リラックス シャワー シャツ ズボン スカート コート "
        "セーター ネクタイ ハンカチ タオル ジュース ワイン チーズ "
        "ケーキ チョコレート アイスクリーム サラダ スープ カレー "
        "ラーメン パスタ ピザ ハンバーガー サンドイッチ", NOUN, 2400)
    # --- institutions / compound pieces (the units compounds decompose
    # into under mode="search"; kuromoji gets these from ipadic) ---
    add("大学 大学院 学院 高校 中学 小学 小学校 中学校 学部 学科 "
        "研究所 研究室 研究科 協会 委員会 組合 連盟 財団 法人 "
        "株式会社 有限会社 会社員 公務員 空港 国際 関西 関東 成田 "
        "羽田 先端 硬式 軟式 野球 庭球 蹴球 水泳 陸上 体操 "
        "新聞 新聞社 出版 出版社 放送 放送局 銀行員 省 庁 局 部門 "
        "課 係 支店 本店 本社 支社 工場 事務所 窓口", NOUN, 2400)
    # --- business / tech / title katakana (compound pieces) ---
    add("アルパイン マテリアルズ セミ コンダクター エクィップメント "
        "オリエンタル チエン マース リレハンメル "
        "シニア ジュニア エンジニア エンジニアリング プロジェクト "
        "マネジャー マネージャー マネジメント セールス マーケティング "
        "アーキテクト アドミニストレータ アドミニストレーター "
        "コンサルタント ディレクター プロデューサー デザイナー "
        "プログラマ プログラマー アナリスト スペシャリスト リーダー "
        "テクノロジー プロテイン モバイル ホールディングス "
        "コーポレーション カンパニー センター ショッピング クリスマス "
        "オリンピック パラリンピック ワールドカップ スタジアム "
        "コンピューター インターフェース プラットフォーム "
        "セキュリティ プライバシー ロボット センサー バッテリー "
        "ディスプレイ スピーカー マイク プリンター スキャナー", NOUN, 2400)
    # --- famous proper nouns (ipadic carries person/company names) ---
    add("ソフトバンク トヨタ ホンダ ニッサン ソニー パナソニック "
        "キヤノン ニコン サッポロ アサヒ キリン フジ ヤマダ "
        "ピーター マイケル ジャクソン スティーブ ジョブズ ビル "
        "ゲイツ ジョン ポール ジョージ メアリー アンナ トム "
        "パン ケーブル ワイヤ チェーン リング", NOUN, 2500)
    # --- adnominals + colloquial nouns/particles (the Botchan external
    # corpus exposed these as missing; standard modern forms) ---
    add("こんな そんな あんな どんな いろんな 大きな 小さな", ADJ, 2400)
    add("みんな あなた うち もん やつ あと ほか まま 屋 奴ら 連中 "
        "気 方 訳 筈 様子 調子 具合 癖 度胸 月給 辞令 田舎 宿 茶代 "
        "狸 山嵐 うらなり 赤シャツ 野だいこ 婆さん 爺さん 生徒 "
        "職員 教頭 校長 教師 下宿 蕎麦 団子 温泉 祝勝 会", NOUN, 2500)
    add("それから だって なんて 何だか なぜか どうも どうせ まるで "
        "さっそく いきなり なかなか ちっとも とうとう 大分 余程 "
        "少々 随分 もう少し", ADV, 2400)
    add("という かも って とか やら なんか ばかり ぐらい くらい",
        PART, 1400)
    # --- Meiji-era / literary forms (novels in the reference's own
    # Japanese test corpus use this orthography) ---
    add("おれ おまえ あいつ こいつ そいつ やつ 奴 俺 僕ら 君ら "
        "此処 其処 彼処 何処 此の 其の 彼の 是 此れ 其れ "
        "云う 云い 云って 云った 貰う 貰い 貰って 貰った 呉れる "
        "呉れ 呉れた 居る 居り 居て 居た 居ない 仕舞う 仕舞った "
        "出来る 出来ない 出来た 有る 有り 有った 無い 無く 無かった "
        "御 御前 時分 頃 奥さん 先生方", NOUN, 2600)
    return d


_DICT = _build_dictionary()
_MAX_WORD = max(len(w) for w in _DICT)


# generated-conjugation-row cost offsets over the dictionary form's cost
# (ambiguity knobs: cheap rows segment more conjugations but over-split
# ordinary text; values are tuned against the genuine corpora and pinned
# by test_ja_external's floors)
_OFF_MIZEN = 300    # godan a-column stem (書か)
_OFF_RENYO = 200    # godan i-column stem (書き)
_OFF_KATEI = 400    # godan e-column stem (書け)
_OFF_ADJ_KU = 200   # i-adjective 〜く / 〜かっ rows
_OFF_ADJ_RARE = 500  # i-adjective 〜かろ / 〜けれ rows


def _build_ipadic_variant():
    """Derive the IPADIC-convention dictionary from the bundled one.

    IPADIC (the dictionary kuromoji ships, and the ground truth behind
    the reference's jawiki/bocchan feature files) emits conjugated
    predicates as stem + inflection rows: 行って -> 行っ|て, 読んだ ->
    読ん|だ, 面白かった -> 面白かっ|た, ました -> まし|た. The bundled
    textbook-convention dictionary lists whole conjugated forms instead
    (golden suites pin that convention). This builder SYSTEMATICALLY
    rewrites the conjugated rows:

    * verb te/ta pair rows (added together by ``add_te``) collapse to
      their shared euphonic stem (行って/行った -> 行っ) — the て/た/で/だ
      endings are already INFL entries;
    * i-adjective かった/くて rows collapse to the 〜かっ / 〜く stems;
    * fused auxiliary chains (ました, ている, なかった, でしょう...)
      are replaced by their IPADIC morpheme rows (まし, て+いる, なかっ,
      でしょ+う).

    The derivation is mechanical over the existing dictionary, so every
    verb/adjective the dictionary ever learns gets its IPADIC rows for
    free; tests/test_ja_external.py pins the resulting span-F1 against
    kuromoji's own corpus files.
    """
    kana_pairs = {"て": "た", "で": "だ"}
    dic: dict[str, list[tuple[int, int]]] = {}

    def add(w, cost, cls):
        entries = dic.setdefault(w, [])
        for i, (c0, k0) in enumerate(entries):
            if k0 == cls:
                entries[i] = (min(c0, cost), cls)
                return
        entries.append((cost, cls))

    # fused INFL/AUX chains the textbook dictionary lists whole, with
    # their IPADIC morpheme splits handled by the rows added below
    drop_infl = {"ました", "ません", "ませんでした", "たかった",
                 "なかった", "ている", "ていた", "ています", "ていました",
                 "てある", "ておく", "てみる", "います", "いました",
                 "いません", "あります", "ありました", "れば", "なくて"}
    drop_aux = {"でした", "でしょう", "だった", "だろう", "ではない",
                "じゃない", "かもしれない"}

    # あ-column / い-column kana for godan mizenkei/renyoukei generation
    _A_COL = {"う": "わ", "く": "か", "ぐ": "が", "す": "さ", "つ": "た",
              "ぬ": "な", "ぶ": "ば", "む": "ま", "る": "ら"}
    _I_COL = {"う": "い", "く": "き", "ぐ": "ぎ", "す": "し", "つ": "ち",
              "ぬ": "に", "ぶ": "び", "む": "み", "る": "り"}
    _E_COL = {"う": "え", "く": "け", "ぐ": "げ", "す": "せ", "つ": "て",
              "ぬ": "ね", "ぶ": "べ", "む": "め", "る": "れ"}

    def _is_verbal_noun(vn):
        # サ変 verbal noun: a kanji compound (勉強, 説明), a known noun
        # (買い物), or a listed 〜する form — NOT a godan renyoukei tail
        # like 乾か in 乾かし
        return len(vn) >= 2 and (
            all(_char_class(c) == "han" for c in vn)
            or any(k == NOUN for _c, k in _DICT.get(vn, ()))
            or (vn + "する") in _DICT)

    for w, entries in _DICT.items():
        for cost, cls in entries:
            if cls == INFL and w in drop_infl:
                continue
            if cls == AUX and w in drop_aux:
                continue
            if len(w) >= 2 and w[-1] in kana_pairs and \
                    any(k in (VERB, NOUN) for _c, k in
                        _DICT.get(w[:-1] + kana_pairs[w[-1]], ())):
                # te-form with a ta-form sibling: conjugated row pair ->
                # shared euphonic stem (classes VERB; the literary set
                # used NOUN, normalize to VERB so INFL binds cheaply)
                add(w[:-1], cost, VERB)
                continue
            if len(w) >= 2 and w[-1] in ("た", "だ") and \
                    any(k in (VERB, NOUN) for _c, k in
                        _DICT.get(w[:-1] + {"た": "て", "だ": "で"}[w[-1]],
                                  ())):
                continue  # ta-form sibling: stem added by the て row
            if cls == VERB and len(w) >= 3 and w.endswith("し") and \
                    _is_verbal_noun(w[:-1]):
                # suru-verb stem (勉強し): IPADIC splits noun + し — the
                # verbal noun becomes a NOUN row whether or not the
                # textbook dictionary listed it as one
                add(w[:-1], cost, NOUN)
                continue
            if cls == VERB and len(w) >= 4 and w.endswith("する") and \
                    _is_verbal_noun(w[:-2]):
                add(w[:-2], cost, NOUN)
                continue  # サ変 dictionary form: noun + する rows cover it
            if cls == ADJ and w.endswith("かった"):
                add(w[:-1], cost, ADJ)  # 面白かっ
                continue
            if cls == ADJ and w.endswith("くて"):
                add(w[:-1], cost, ADJ)  # 面白く
                continue
            if cls == NOUN and len(w) == 2 and w[0] in "一二三四五六七八九十何数" \
                    and w[1] in "人つ個本日年月円歳回分時":
                # fused numeral+counter rows: IPADIC splits 一|人
                continue
            if cls == VERB and len(w) >= 2 and w[-1] in _A_COL:
                # dictionary-form verb: generate IPADIC conjugation rows.
                # ichidan (stem already a dictionary VERB row, 食べ) needs
                # none; godan gets mizenkei (書か), renyoukei (書き) and
                # kateikei/meireikei (書け) stems. Offsets empirically
                # tuned on the genuine corpora (test_ja_external floors).
                add(w, cost, cls)
                stem = w[:-1]
                is_ichidan = w[-1] == "る" and any(
                    k == VERB for _c, k in _DICT.get(stem, ()))
                if not is_ichidan and stem:
                    add(stem + _A_COL[w[-1]], cost + _OFF_MIZEN, VERB)
                    add(stem + _I_COL[w[-1]], cost + _OFF_RENYO, VERB)
                    add(stem + _E_COL[w[-1]], cost + _OFF_KATEI, VERB)
                continue
            if cls == ADJ and w.endswith("い") and len(w) >= 2:
                # i-adjective: 高く / 高かっ / 高かろ / 高けれ rows
                add(w, cost, cls)
                stem = w[:-1]
                add(stem + "く", cost + _OFF_ADJ_KU, ADJ)
                add(stem + "かっ", cost + _OFF_ADJ_KU, ADJ)
                add(stem + "かろ", cost + _OFF_ADJ_RARE, ADJ)
                add(stem + "けれ", cost + _OFF_ADJ_RARE, ADJ)
                continue
            add(w, cost, cls)

    # IPADIC morpheme rows for the dropped fusions + high-frequency
    # literary inflections (Botchan register): polite まし/ませ, the
    # negative stem なかっ, conjectural だろ/でしょ, conditional たら/なら,
    # quotative って, and bare auxiliary stems
    for w in ("まし", "ませ", "でし", "なかっ", "だろ", "でしょ", "けれ",
              "なく", "なくっ", "たら", "だら", "なら", "たり", "だり",
              "てる", "とる", "ちゃ", "じゃ", "ちまっ", "ちゃっ"):
        add(w, 1600, INFL)
    for w in ("ん", "う", "ば", "ず", "ぬ", "まい", "たい", "たく"):
        add(w, 1800, INFL)
    for w in ("ながら", "つつ", "って", "とか", "やら", "ほど", "くらい",
              "ぐらい", "ばかり", "だの", "きり", "なり"):
        add(w, 1400, PART)
    # bare verb/auxiliary stems IPADIC uses that the textbook rows fuse
    for w in ("し", "来", "出来", "れ", "られ", "せ", "させ", "い", "み",
              "いっ", "あっ", "なっ", "やっ", "もらっ", "くれ", "あげ",
              "しまっ", "おい", "おっ", "みせ", "みる", "くる", "しまう",
              "おく", "やる", "くれる", "もらう", "あげる", "いく"):
        add(w, 2400, VERB)
    return dic


_DICT_IPADIC = None  # built lazily on first convention="ipadic" call


def _ipadic_dict():
    global _DICT_IPADIC
    if _DICT_IPADIC is None:
        d = _build_ipadic_variant()
        _DICT_IPADIC = (d, max(len(w) for w in d))
    return _DICT_IPADIC


def ipadic_base():
    """The ipadic-convention (dict, max_word) — the ``base=`` for
    ``merge_entries`` when a user lexicon should ride that convention."""
    return _ipadic_dict()

# connection-cost matrix at class granularity (kuromoji's matrix.def role).
# Base cost 1000; cheap/expensive pairs tuned for the golden suite.
_CONN_DEFAULT = 1000
_CONN = {
    (NOUN, PART): 0, (VERB, INFL): -800, (INFL, INFL): -200,
    (VERB, AUX): 400, (INFL, AUX): 300, (NOUN, AUX): 200,
    (ADJ, AUX): 200, (ADJ, INFL): 0, (PART, VERB): 200, (PART, NOUN): 200,
    (PART, ADJ): 200, (PART, ADV): 200, (PART, PART): 1500,
    (PRE, NOUN): -200, (NOUN, SUF): -400, (UNK, SUF): -200,
    (ADV, VERB): 200, (ADV, ADJ): 200, (AUX, PART): 300,
    (NOUN, NOUN): 1400, (VERB, VERB): 1800, (UNK, PART): 100,
    (PART, UNK): 300, (UNK, UNK): 1600,
}
_BOS_COST = {PART: 1200, INFL: 1500, AUX: 900, SUF: 1500}


def _conn(a, b):
    return _CONN.get((a, b), _CONN_DEFAULT)


def _char_class(ch):
    code = ord(ch)
    if 0x4E00 <= code <= 0x9FFF or ch in "々〆ヶ":
        return "han"
    if 0x3040 <= code <= 0x309F:
        return "hira"
    if 0x30A0 <= code <= 0x30FF or ch == "ー":
        return "kata"
    if ch.isdigit():
        return "num"
    if ch.isalpha():
        return "latin"
    if unicodedata.category(ch).startswith("Z") or ch.isspace():
        return "space"
    return "sym"


def _unknown_candidates(text, i):
    """Kuromoji-style unknown-word invocation: candidates from the maximal
    same-class run at i, length-penalized. Returns [(surface, cost, cls)]."""
    cls = _char_class(text[i])
    j = i
    while j < len(text) and _char_class(text[j]) == cls:
        j += 1
    run = j - i
    out = []
    if cls in ("kata", "latin", "num"):
        # loanwords / numbers: the whole run is the natural token
        out.append((text[i:i + run], 4000 + 100 * run, NOUN))
        if run > 1:
            out.append((text[i:i + 1], 7000, UNK))
    elif cls == "han":
        # unknown kanji: favor 1-2 char pieces (compound nouns build up)
        for ln in (1, 2, 3):
            if ln <= run:
                out.append((text[i:i + ln], 5000 + 1700 * ln, UNK))
    elif cls == "hira":
        out.append((text[i:i + 1], 6500, UNK))
        if run >= 2:
            out.append((text[i:i + 2], 9500, UNK))
    elif cls == "space":
        out.append((text[i:i + run], 0, SYM))
    else:
        # one token PER symbol (kuromoji's convention: 、 。 》 each its
        # own token) — EXCEPT a repeat-run of the same symbol (----,
        # 。。。), which ipadic's unknown handling keeps whole
        j2 = i
        while j2 < i + run and text[j2] == text[i]:
            j2 += 1
        out.append((text[i:j2], 3000, SYM))
    return out


def merge_entries(user_entries, base=None):
    """Merge a user lexicon over the bundled dictionary ONCE; pass the
    result to ``tokenize(merged=...)`` in per-document loops (same
    contract as zh_lattice.merge_entries). Returns (dict, max_word).
    ``base``: an alternative (dict, max_word) to merge over (e.g. the
    ipadic-convention variant)."""
    base_dic, base_max = base if base is not None else (_DICT, _MAX_WORD)
    if not user_entries:
        return (base_dic, base_max)
    dic = dict(base_dic)
    max_w = base_max
    if isinstance(user_entries, dict):
        extra = user_entries.items()
    else:
        extra = ((w, (2000, NOUN)) for w in user_entries)
    for w, v in extra:
        dic.setdefault(w, [])
        dic[w] = dic[w] + [v if isinstance(v, tuple) else (2000, NOUN)]
        max_w = max(max_w, len(w))
    return (dic, max_w)


# search-mode decompounding penalties (kuromoji Mode.SEARCH,
# viterbi/ViterbiBuilder heuristic: kanji tokens longer than 2 and other
# tokens longer than 7 pay a per-extra-char penalty, so the lattice
# prefers splitting compounds whenever the pieces are lattice-reachable —
# kuromoji uses 10000 on its cost scale; ours is calibrated to this
# dictionary's ~2500-per-word costs and pinned by the genuine
# search-segmentation-tests.txt suite)
_SEARCH_KANJI_LEN = 2
_SEARCH_OTHER_LEN = 7
_SEARCH_PENALTY = 3500


def _search_penalty(surface):
    n = len(surface)
    if n > _SEARCH_KANJI_LEN and all(_char_class(c) == "han"
                                     for c in surface):
        return _SEARCH_PENALTY * (n - _SEARCH_KANJI_LEN)
    if n > _SEARCH_OTHER_LEN:
        return _SEARCH_PENALTY * (n - _SEARCH_OTHER_LEN)
    return 0


class UserDictionary:
    """kuromoji user dictionary (UserDictionary.java semantics): CSV lines
    ``surface,custom segmentation,readings,pos`` — when ``surface`` occurs
    in the text, its custom segmentation is FORCED, taking precedence over
    the lattice (the reference ships tests/resources/userdict.txt in this
    exact format: 日本経済新聞 -> 日本 経済 新聞; 朝青龍 kept whole)."""

    def __init__(self, entries):
        #: {surface: [piece, ...]} — longest surfaces matched first
        self.entries = dict(entries)
        ordered = sorted(self.entries, key=len, reverse=True)
        self._pattern = re.compile(
            "|".join(re.escape(s) for s in ordered) or r"(?!x)x")

    @classmethod
    def load(cls, path):
        entries = {}
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                cols = line.split(",")
                if len(cols) < 2:
                    continue
                surface = unicodedata.normalize("NFKC", cols[0].strip())
                pieces = [unicodedata.normalize("NFKC", p)
                          for p in cols[1].split() if p]
                if surface and pieces:
                    entries[surface] = pieces
        return cls(entries)

    def split(self, text):
        """[(segment, forced_pieces_or_None), ...] — occurrences of user
        surfaces become forced segments, the rest flows to the lattice.
        One precompiled alternation (longest surface first, like the
        kuromoji user-dict FST) — linear in the text, not
        O(entries x chars)."""
        out = []
        pos = 0
        for m in self._pattern.finditer(text):
            if m.start() > pos:
                out.append((text[pos:m.start()], None))
            out.append((m.group(0), self.entries[m.group(0)]))
            pos = m.end()
        if pos < len(text):
            out.append((text[pos:], None))
        return out


def tokenize(text, user_entries=None, merged=None, mode="normal",
             user_dict=None, convention="default"):
    """Viterbi lattice segmentation. Returns the token list (whitespace
    tokens dropped). ``user_entries``: one-off {surface: (cost, cls)} or
    iterable of surfaces merged over the bundled dictionary (see
    ``merge_entries`` for the cached form callers in loops should use).
    ``mode="search"``: kuromoji-style decompounding for search/indexing —
    long compounds split into their lattice-reachable pieces.
    ``convention="ipadic"``: IPADIC morpheme granularity (行っ|て, まし|た
    — see ``_build_ipadic_variant``), the convention kuromoji's own
    corpus ground truth uses; the default keeps textbook whole-form
    conjugations."""
    if mode not in ("normal", "search"):
        raise ValueError(f"unknown tokenize mode {mode!r}")
    if convention not in ("default", "ipadic"):
        raise ValueError(f"unknown convention {convention!r}")
    if merged is not None and convention != "default":
        raise ValueError(
            "merged= already fixes the dictionary; build it over the "
            "requested convention instead: merge_entries(entries, "
            "base=ipadic_base())")
    if user_dict is not None:
        toks = []
        for seg, forced in user_dict.split(
                unicodedata.normalize("NFKC", text)):
            if forced is not None:
                toks.extend(forced)
            else:
                toks.extend(tokenize(seg, user_entries=user_entries,
                                     merged=merged, mode=mode,
                                     convention=convention))
        return toks
    if merged is not None:
        dic, max_w = merged
    else:
        base = _ipadic_dict() if convention == "ipadic" else None
        dic, max_w = merge_entries(user_entries, base=base)

    # NFKC first — same normalization every factory path applies (half-width
    # katakana, full-width latin/digits fold to their canonical forms; the
    # dictionary and char classes assume canonical text)
    text = unicodedata.normalize("NFKC", text)
    n = len(text)
    if n == 0:
        return []
    INF = float("inf")
    # best[pos][cls] = (cost, prev_pos, prev_cls, surface)
    best = [dict() for _ in range(n + 1)]
    best[0] = {SYM: (0.0, -1, -1, "")}  # BOS acts like a symbol boundary

    for i in range(n):
        if not best[i]:
            continue
        cands = []
        upper = min(n, i + max_w)
        for j in range(i + 1, upper + 1):
            for cost, cls in dic.get(text[i:j], ()):
                cands.append((text[i:j], cost, cls))
        cands.extend(_unknown_candidates(text, i))
        if mode == "search":
            cands = [(s, c + _search_penalty(s), k) for s, c, k in cands]
        for surface, wcost, cls in cands:
            j = i + len(surface)
            for pcls, (pcost, *_rest) in best[i].items():
                if pcost == INF:
                    continue
                conn = (_BOS_COST.get(cls, 0) if i == 0
                        else _conn(pcls, cls))
                total = pcost + wcost + conn
                cur = best[j].get(cls)
                if cur is None or total < cur[0]:
                    best[j][cls] = (total, i, pcls, surface)

    # backtrack from the cheapest end state
    if not best[n]:
        return [text]
    cls = min(best[n], key=lambda c: best[n][c][0])
    pos = n
    toks = []
    while pos > 0:
        _, prev, pcls, surface = best[pos][cls]
        toks.append(surface)
        pos, cls = prev, pcls
    toks.reverse()
    return [t for t in toks if t.strip()]
