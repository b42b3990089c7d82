"""Lattice-based Chinese word segmenter (Viterbi).

Reference analog: deeplearning4j-nlp-chinese — the ansj_seg segmenter
(~75 files: core n-gram dictionary lookup over a double-array trie,
person-name recognition, numeral/quantifier rules, and a shortest-path
search over the word lattice). This module implements the same design
self-contained, the ``text/ja_lattice.py`` precedent applied to Mandarin:

1. **Dictionary lookup**: every substring (bounded length) from each
   position is matched against an embedded dictionary of words, each
   carrying a word cost (≈ -log frequency, coarsened) and a part-of-speech
   connection class.
2. **Rule candidates**: numeral runs (arabic or Chinese numerals) followed
   by measure words, latin/digit runs as whole tokens, and ansj's
   signature person-name rule — a common surname followed by one or two
   non-dictionary han characters spawns a name candidate.
3. **Viterbi**: dynamic programming over (position, class) minimizing
   word+connection cost; the connection matrix is a compact class-pair
   table (numeral→measure cheap, adjective→noun cheap, particle after
   verb/noun cheap — the bigram-frequency core dictionary's role at class
   granularity).

The bundled dictionary is a starter lexicon of high-frequency Mandarin
words (golden-tested in tests/test_text.py); production use merges a
domain dictionary via ``user_entries``.
"""

from __future__ import annotations

import os
import unicodedata

# connection classes
NOUN, VERB, ADJ, ADV, PRON, NUM, MEAS, PART, CONJ, PREP, NAME, UNK = \
    range(12)


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

    # --- pronouns / demonstratives ---
    add("我 你 您 他 她 它 我们 你们 他们 她们 它们 自己 大家 咱们 "
        "这 那 这个 那个 这些 那些 这里 那里 哪里 哪个 谁 什么 怎么 "
        "为什么 多少 几 这样 那样 怎样", PRON, 2000)
    # --- high-frequency nouns ---
    add("人 事 物 年 月 日 天 时 时候 时间 地方 国家 首都 政府 人民 "
        "世界 中国 北京 "
        "上海 天安门 问题 工作 学习 学校 老师 学生 朋友 孩子 先生 "
        "小姐 女士 东西 事情 生活 社会 经济 政治 文化 历史 科学 技术 "
        "机器 数据 模型 训练 智能 计算 网络 电脑 手机 电话 汽车 火车 "
        "飞机 城市 农村 公司 单位 家 家庭 父母 爸爸 妈妈 哥哥 弟弟 "
        "姐姐 妹妹 儿子 女儿 水 火 山 河 海 天 地 路 门 窗 书 报 笔 "
        "纸 桌子 椅子 房子 钱 饭 菜 肉 鱼 鸡 蛋 水果 苹果 米饭 面条 "
        "茶 咖啡 牛奶 啤酒 春天 夏天 秋天 冬天 今天 明天 昨天 现在 "
        "以前 以后 将来 过去 早上 上午 中午 下午 晚上 夜里 星期 礼拜 "
        "名字 意思 办法 方法 原因 结果 目的 条件 情况 关系 影响 作用 "
        "能力 水平 程度 方面 方向 部分 全部 内容 形式 声音 颜色 味道 "
        "感觉 心情 身体 健康 医院 医生 病人 药 伤 痛 语言 汉语 英语 "
        "中文 英文 文章 句子 词 字 话", NOUN, 2800)
    # --- verbs ---
    add("是 有 在 来 去 到 说 看 听 想 要 会 能 可以 应该 必须 需要 "
        "知道 认识 了解 明白 懂 觉得 认为 希望 喜欢 爱 恨 怕 做 干 "
        "作 用 拿 放 给 送 带 买 卖 吃 喝 睡 睡觉 起床 走 跑 飞 游 "
        "坐 站 躺 住 开 关 打 打开 关上 写 读 念 学 教 问 回答 告诉 "
        "帮助 找 丢 得到 失去 开始 结束 继续 停止 变 变成 成为 发生 "
        "出现 消失 进 出 上 下 回 回来 回去 过 过来 过去 起 起来 "
        "工作 休息 玩 笑 哭 生气 高兴 担心 放心 小心 注意 记得 忘记 "
        "等 等待 见 见面 遇到 碰到 参加 离开 经过 通过 完成 实现 "
        "研究 发现 发明 创造 生产 建设 发展 提高 改变 解决 决定 选择 "
        "准备 打算 计划 试 尝试 练习 复习 预习 考试 毕业 上班 下班 "
        "上课 下课 开车 坐车 骑车 走路 旅行 旅游 唱歌 跳舞 画画 "
        "游泳 跑步 锻炼 运动 比赛 赢 输", VERB, 2600)
    # --- adjectives ---
    add("大 小 多 少 高 低 长 短 宽 窄 厚 薄 快 慢 早 晚 新 旧 好 "
        "坏 对 错 真 假 美 丑 胖 瘦 冷 热 暖和 凉快 干净 脏 安静 吵 "
        "忙 闲 累 饿 渴 饱 困 漂亮 好看 难看 好吃 难吃 好听 难听 "
        "容易 简单 复杂 困难 重要 主要 必要 可能 一样 不同 相同 特别 "
        "普通 一般 有名 著名 年轻 年老 聪明 笨 认真 马虎 努力 勤奋 "
        "懒 快乐 幸福 痛苦 难过 伤心 奇怪 正常 方便 舒服 危险 安全 "
        "便宜 贵 远 近 深 浅 强 弱 轻 重 满 空 够 整齐 乱", ADJ, 2700)
    # --- adverbs ---
    add("不 没 没有 很 太 真 最 更 还 也 都 只 就 才 又 再 常 常常 "
        "经常 总是 一直 已经 曾经 刚 刚才 马上 立刻 正在 一起 一共 "
        "大概 也许 可能 当然 一定 必然 几乎 差不多 非常 十分 特别 "
        "比较 稍微 有点 有点儿 越来越 忽然 突然 终于 到底 究竟 原来 "
        "其实 确实 的确 互相 亲自 故意 尤其 甚至", ADV, 2400)
    # --- numerals + measure words ---
    add("一 二 三 四 五 六 七 八 九 十 百 千 万 亿 零 两 半 第一 "
        "第二 第三 许多 很多 好多 一些 有些 一点 一点儿", NUM, 2200)
    add("个 只 条 张 把 件 本 台 辆 架 艘 头 匹 棵 朵 座 间 套 双 "
        "对 副 群 批 次 遍 趟 回 下 年 月 日 天 小时 分钟 秒 块 元 "
        "角 分 斤 公斤 米 公里 岁 位 名 口 家 种 样 层 页 句 段 篇 "
        "部 场 首 幅 支 枝 枚 粒 颗 滴 杯 瓶 碗 盘 锅 包 盒 箱 "
        "袋", MEAS, 2000)
    # --- particles / aspect markers ---
    add("的 地 得 了 着 过 吗 呢 吧 啊 呀 嘛 哦 啦 们 所 之 者", PART, 800)
    # --- conjunctions ---
    add("和 与 跟 同 或 或者 还是 而 而且 并且 不但 不仅 但是 可是 "
        "不过 然而 因为 所以 因此 于是 如果 要是 假如 虽然 尽管 无论 "
        "不管 只要 只有 除非 然后 接着 首先 其次 最后 另外 此外 "
        "比如 例如 总之", CONJ, 1800)
    # --- prepositions ---
    add("在 从 向 往 朝 对 对于 关于 至于 按 按照 根据 通过 经过 "
        "为 为了 被 把 让 叫 比 跟 给 替 除了 自从 直到 离", PREP, 1900)
    # --- greetings / set phrases ---
    add("你好 您好 谢谢 再见 请问 对不起 没关系 不客气 欢迎 恭喜", NOUN, 1500)
    # --- everyday nouns: body / food / home / city ---
    add("头 脸 眼睛 耳朵 鼻子 嘴 手 脚 腿 胳膊 手指 头发 心 身体 "
        "声音 眼泪 笑容 肚子 背 腰 牙 牙齿 皮肤 骨头 血 "
        "早饭 午饭 晚饭 早餐 午餐 晚餐 米饭 面条 面包 鸡蛋 牛奶 "
        "茶 咖啡 啤酒 白酒 果汁 汽水 水果 苹果 香蕉 西瓜 葡萄 橙子 "
        "蔬菜 土豆 西红柿 白菜 豆腐 牛肉 猪肉 鸡肉 鱼肉 羊肉 汤 "
        "糖 盐 油 醋 酱油 味道 菜单 餐厅 饭馆 厨房 "
        "房间 客厅 卧室 卫生间 厕所 窗户 门口 墙 地板 天花板 院子 "
        "钥匙 桌子 椅子 沙发 床 柜子 书架 灯 空调 冰箱 洗衣机 "
        "电视 电视机 收音机 照相机 衣服 裤子 裙子 衬衫 外套 毛衣 "
        "鞋 鞋子 袜子 帽子 眼镜 手表 雨伞 包 钱包 行李 礼物 "
        "医院 医生 护士 病人 感冒 发烧 药 药店 警察 消防 银行 "
        "邮局 图书馆 公园 博物馆 电影院 机场 车站 码头 桥 红绿灯 "
        "路口 地图 车票 机票 地铁 火车 高铁 公共汽车 出租车 自行车 "
        "摩托车 卡车 船 街 街道 马路 大楼 大厦 商店 商场 超市 "
        "市场 宾馆 酒店 教堂 寺庙 广场 球场 游泳池 健身房", NOUN, 2300)
    # --- school / work / society nouns ---
    add("问题 答案 作业 考试 课 课程 教室 黑板 词典 杂志 报纸 小说 "
        "故事 文章 句子 单词 汉字 拼音 语法 意思 成绩 分数 毕业 "
        "爱好 旅游 旅行 散步 购物 打扫 运动 锻炼 比赛 运动员 冠军 "
        "音乐会 演出 节目 节日 春节 中秋节 国庆节 生日 婚礼 "
        "工资 价格 价钱 收入 利润 会议 材料 报告 通知 消息 建议 "
        "意见 办法 计划 目标 任务 责任 机会 经验 能力 水平 态度 "
        "习惯 性格 脾气 感情 爱情 友谊 印象 记忆 梦 梦想 希望 "
        "关系 影响 情况 状态 环境 条件 标准 程度 比例 数量 质量 "
        "部分 整体 中心 周围 附近 旁边 对面 中间 里面 外面 上面 "
        "下面 前面 后面 左边 右边 东边 西边 南边 北边 方向 距离 "
        "种类 形状 大小 长度 重量 高度 深度 宽度 速度 力量 温度 "
        "重点 特点 优点 缺点 好处 坏处 原因 结果 过程 规律 原则 "
        "知识 智慧 思想 观点 理论 事实 真相 证据 例子 数据 数字 "
        "密码 网站 网络 网页 邮件 手机 电脑 软件 硬件 程序 代码 "
        "算法 人工智能 机器人 屏幕 键盘 鼠标 文件 文件夹 系统 "
        "平台 用户 账号 视频 音频 照片 图片 游戏 新闻 广告", NOUN, 2300)
    # --- places / languages ---
    add("亚洲 欧洲 非洲 美洲 美国 英国 法国 德国 意大利 西班牙 "
        "俄罗斯 印度 日本 韩国 泰国 越南 新加坡 澳大利亚 加拿大 "
        "巴西 上海 广州 深圳 天津 重庆 成都 杭州 南京 武汉 西安 "
        "香港 澳门 台湾 汉语 英语 日语 法语 德语 西班牙语 俄语 "
        "普通话 方言 外语 母语", NOUN, 2300)
    # --- more verbs ---
    add("唱 唱歌 跳 跳舞 哭 笑 生气 吃惊 高兴 着急 停 停止 动 移动 "
        "推 拉 扔 打开 关上 关闭 搬 搬家 爬 爬山 上车 下车 上班 "
        "下班 上学 放学 起床 睡觉 洗澡 刷牙 洗脸 穿 脱 戴 摘 挂 "
        "放 拿 捡 丢 收 收拾 整理 选 选择 决定 检查 调查 研究 "
        "寻找 找到 发现 发明 表示 表达 表演 介绍 解释 说明 翻译 "
        "回答 提问 讨论 交流 沟通 商量 同意 反对 批评 表扬 鼓励 "
        "帮助 照顾 保护 救 陪 送 接 迎接 邀请 拜访 访问 参观 "
        "参加 组织 举行 举办 庆祝 准备 安排 计划 完成 实现 成功 "
        "失败 赢 输 借 还 赚 花 省 存 取 付 买单 结账 降价 涨价 "
        "打折 修 修理 坏 破 碎 断 掉 丢失 忘记 记住 记得 想起 "
        "明白 理解 懂 认识 认为 觉得 感觉 感到 相信 怀疑 担心 "
        "害怕 喜欢 讨厌 爱上 想念 羡慕 尊重 佩服 感谢 道歉 原谅 "
        "增加 减少 提高 降低 改变 改进 改善 发展 进步 扩大 缩小 "
        "开始 继续 结束 保持 保存 删除 更新 搜索 下载 上传 安装 "
        "登录 注册 点击 输入 输出 打印 复制 粘贴 发送 接收 回复 "
        "联系 通知 预订 预约 订 点菜 尝 闻 摸 抱 握手 鼓掌 点头 "
        "摇头 抬头 低头 转身 回头 出发 到达 经过 路过 迷路 问路",
        VERB, 2400)
    # --- more adjectives ---
    add("重 轻 粗 细 硬 软 尖 钝 圆 方 直 弯 平 斜 满 空 干 湿 "
        "亮 暗 深 浅 胖 瘦 年轻 年老 聪明 笨 勤奋 懒 认真 马虎 "
        "仔细 粗心 耐心 热情 冷淡 友好 礼貌 诚实 善良 勇敢 胆小 "
        "骄傲 谦虚 大方 小气 温柔 严格 幽默 可爱 漂亮 英俊 丑 "
        "干净 脏 整齐 乱 安静 吵 热闹 拥挤 宽敞 舒服 舒适 方便 "
        "麻烦 简单 容易 困难 复杂 特别 普通 一般 奇怪 正常 自然 "
        "重要 主要 必要 严重 危险 安全 健康 紧张 轻松 愉快 开心 "
        "快乐 幸福 难过 伤心 失望 满意 激动 兴奋 无聊 有趣 有名 "
        "著名 流行 时髦 新鲜 成熟 丰富 充分 足够 完整 完美 优秀 "
        "先进 落后 发达 贫穷 富裕 昂贵 便宜 免费 真实 虚假 清楚 "
        "模糊 准确 正确 错误 合适 合理 公平 积极 消极 主动 被动",
        ADJ, 2400)
    # --- more adverbs / time words ---
    # --- 家/者/员-derived professions (ansj's derivational nouns) ---
    add("科学家 艺术家 作家 画家 音乐家 专家 企业家 政治家 思想家 "
        "教育家 文学家 数学家 物理学家 化学家 历史学家 哲学家 "
        "发明家 探险家 银行家 记者 学者 读者 作者 译者 消费者 "
        "志愿者 爱好者 工作者 研究者 演员 教员 职员 店员 服务员 "
        "售货员 驾驶员 飞行员 管理员 程序员", NOUN, 2200)
    # --- abstract nouns + common idioms (chengyu enter ansj's core
    # dictionary whole) ---
    add("和平 美好 幸福 自由 正义 真理 理想 信念 信心 勇气 "
        "荣誉 尊严 价值 意义 精神 灵魂 命运 奇迹 "
        "青山绿水 绿水青山 山清水秀 万事如意 一帆风顺 四面八方 "
        "五颜六色 七上八下 十全十美 百花齐放 千方百计 万紫千红 "
        "自言自语 全心全意 实事求是 名副其实", NOUN, 2200)
    # --- locatives + 每-compounds + campus/tech words the held-out
    # sentences exposed as missing ---
    add("里 外 上 下 内 中 旁 边 处", NOUN, 2100)
    add("每天 每年 每月 每周 每次 每个 每人 大学 大学生 中学 中学生 "
        "小学 小学生 学院 系 班 年级 计算机 计算机科学 笔记本 "
        "互联网 人工 智能化", NOUN, 2200)
    add("今天 明天 昨天 前天 后天 今年 明年 去年 前年 后年 现在 "
        "刚才 以前 以后 将来 未来 过去 最近 当时 后来 然后 立刻 "
        "马上 赶快 忽然 逐渐 渐渐 始终 一直 总是 经常 偶尔 有时 "
        "有时候 从来 曾经 已经 正在 刚刚 终于 居然 竟然 差点 几乎 "
        "大约 大概 也许 可能 一定 肯定 确实 的确 当然 其实 原来 "
        "到底 究竟 尤其 特别 非常 十分 相当 稍微 比较 越来越 "
        "一起 一共 一般 互相 亲自 顺便 专门 故意 仍然 依然 照常",
        ADV, 2200)
    return d


_DICT = _build_dictionary()
_MAX_WORD = max(len(w) for w in _DICT)

_SURNAMES = set("王李张刘陈杨赵黄周吴徐孙胡朱高林何郭马罗梁宋郑谢韩唐")

# connection-cost matrix at class granularity (ansj's core bigram
# dictionary role). Base 1000; pairs tuned for the golden suite.
_CONN_DEFAULT = 1000
_CONN = {
    (NUM, MEAS): -600, (MEAS, NOUN): 100, (ADJ, NOUN): 200,
    (PRON, VERB): 100, (NOUN, VERB): 200, (VERB, NOUN): 200,
    (VERB, PART): -200, (NOUN, PART): 0, (ADJ, PART): 0,
    (PART, NOUN): 200, (ADV, VERB): 0, (ADV, ADJ): 0,
    (PREP, NOUN): 100, (PREP, PRON): 100, (CONJ, NOUN): 300,
    (CONJ, VERB): 300, (CONJ, PRON): 300, (VERB, PRON): 200,
    (PRON, NOUN): 400, (NOUN, NOUN): 900, (VERB, VERB): 1200,
    (NUM, NOUN): 500, (NAME, VERB): 200, (NAME, PART): 100,
    (VERB, NAME): 300, (UNK, UNK): 1800, (UNK, PART): 200,
    (PRON, MEAS): -100,
}
_BOS_COST = {PART: 2000, MEAS: 1200, CONJ: 400}


def _conn(a, b):
    return _CONN.get((a, b), _CONN_DEFAULT)


def _is_han(ch):
    o = ord(ch)
    return 0x4E00 <= o <= 0x9FFF or 0x3400 <= o <= 0x4DBF


def _run_class(ch):
    if ch.isdigit():
        return "num"
    if ch.isalpha() and not _is_han(ch):
        return "latin"
    if ch.isspace():
        return "space"
    if _is_han(ch):
        return "han"
    return "sym"


def _rule_candidates(text, i, dic):
    """Non-dictionary candidates: digit/latin runs, person names, and
    single-char unknown fallback. Returns [(surface, cost, cls)]."""
    cls = _run_class(text[i])
    j = i
    while j < len(text) and _run_class(text[j]) == cls:
        j += 1
    run = j - i
    out = []
    if cls in ("num", "latin"):
        out.append((text[i:i + run], 2500, NUM if cls == "num" else NOUN))
        return out
    if cls == "space":
        out.append((text[i:i + run], 0, UNK))
        return out
    if cls == "sym":
        out.append((text[i:i + run], 2500, UNK))
        return out
    # han: unknown single/double char pieces
    out.append((text[i], 5200, UNK))
    if run >= 2:
        out.append((text[i:i + 2], 8200, UNK))
    # ansj person-name invocation: surname + 1-2 following han chars that
    # do not open a dictionary word
    if text[i] in _SURNAMES:
        for ln in (2, 3):
            if i + ln <= len(text) and all(_is_han(c)
                                           for c in text[i:i + ln]):
                if text[i + 1:i + ln] not in dic:
                    out.append((text[i:i + ln], 4500 + 400 * ln, NAME))
    return out


def merge_entries(user_entries):
    """Merge a user lexicon over the bundled dictionary ONCE; pass the
    result to ``tokenize(merged=...)`` in per-document loops.
    ``user_entries``: {surface: (cost, cls)} or iterable of surfaces
    (added as low-cost nouns). Returns an opaque (dict, max_word_len)."""
    if not user_entries:
        return (_DICT, _MAX_WORD)
    dic = dict(_DICT)
    max_w = _MAX_WORD
    if isinstance(user_entries, dict):
        extra = user_entries.items()
    else:
        extra = ((w, (1800, NOUN)) for w in user_entries)
    for w, v in extra:
        dic.setdefault(w, [])
        dic[w] = dic[w] + [v if isinstance(v, tuple) else (1800, NOUN)]
        max_w = max(max_w, len(w))
    return (dic, max_w)


# ---------------------------------------------------------------------------
# Genuine ansj core dictionary (the reference pack's own data)
# ---------------------------------------------------------------------------

# ansj ICTCLAS-style nature tags -> connection classes. Tags observed in
# the reference's core.dic (85,730 word rows): n-family/idiom/place/org ->
# NOUN, v-family -> VERB, a-family + status words -> ADJ, etc. ``w``
# (punctuation) is skipped — the rule candidates already handle symbols.
_ANSJ_NATURE_CLASS = {
    "n": NOUN, "ng": NOUN, "nz": NOUN, "ns": NOUN, "nt": NOUN, "nx": NOUN,
    "nw": NOUN, "l": NOUN, "i": NOUN, "j": NOUN, "s": NOUN, "f": NOUN,
    "b": NOUN, "en": NOUN, "x": NOUN, "k": NOUN, "h": NOUN, "t": NOUN,
    "tg": NOUN, "g": NOUN,
    "v": VERB, "vn": VERB, "vg": VERB, "vd": VERB,
    "a": ADJ, "an": ADJ, "ad": ADJ, "ag": ADJ, "z": ADJ,
    "d": ADV, "dg": ADV,
    "r": PRON, "rg": PRON,
    "m": NUM, "mg": NUM,
    "q": MEAS, "qg": MEAS,
    "u": PART, "y": PART, "e": PART, "o": PART, "ug": PART, "uj": PART,
    "c": CONJ,
    "p": PREP,
    "nr": NAME,
}

#: default in-place location of the reference pack's genuine dictionary: a
#: checkout of the reference named ``reference`` in the home directory
ANSJ_CORE_DIC = os.path.expanduser(
    "~/reference/deeplearning4j-nlp-parent/"
    "deeplearning4j-nlp-chinese/src/main/resources/core.dic")

_ANSJ_CACHE = {}


def load_ansj_core_dic(path=ANSJ_CORE_DIC, merge_bundled=True):
    """Parse the reference pack's GENUINE ansj core dictionary (consumed
    in place, never copied) into a ``merged``-style (dict, max_word_len)
    for :func:`tokenize`.

    Format (ansj_seg's DAT dump, one trie node per line):
    ``code \\t term \\t base \\t check \\t status \\t {nature=freq,...}`` —
    status 1 rows are prefix-only nodes (natures ``null``); status >= 2
    rows are real words carrying their nature->frequency map. Word cost
    falls with frequency (≈ -log f, same shape as the builder lexicon's
    coarse costs); the bundled tuned lexicon is merged underneath by
    default so core function-word costs stay calibrated while the
    genuine data provides the breadth (85k+ surface forms).
    """
    import math

    key = (path, merge_bundled)
    if key in _ANSJ_CACHE:
        return _ANSJ_CACHE[key]
    dic: dict[str, list[tuple[int, int]]] = (
        {w: list(es) for w, es in _DICT.items()} if merge_bundled else {})
    max_w = _MAX_WORD if merge_bundled else 1
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 6 or parts[4] == "1" or parts[5] == "null":
                continue
            word = parts[1]
            if not word or word.isspace():
                continue
            per_class: dict[int, int] = {}
            for item in parts[5].strip("{}").split(","):
                tag, _, freq = item.strip().partition("=")
                cls = _ANSJ_NATURE_CLASS.get(tag)
                if cls is None:
                    continue
                try:
                    fv = int(freq)
                except ValueError:
                    fv = 0
                per_class[cls] = max(per_class.get(cls, 0), fv)
            if not per_class:
                continue
            entries = dic.setdefault(word, [])
            for cls, fv in per_class.items():
                cost = int(min(3200.0, max(
                    1100.0, 3200.0 - 220.0 * math.log2(fv + 2))))
                for i, (c0, k0) in enumerate(entries):
                    if k0 == cls:
                        entries[i] = (min(c0, cost), cls)
                        break
                else:
                    entries.append((cost, cls))
            max_w = max(max_w, len(word))
    out = (dic, max_w)
    _ANSJ_CACHE[key] = out
    return out


def tokenize(text, user_entries=None, merged=None,
             merge_num_quantifier=False):
    """Viterbi lattice segmentation. Returns the token list (whitespace
    dropped). ``user_entries``: one-off lexicon merge (see
    ``merge_entries`` for the cached form callers in loops should use).
    ``merge_num_quantifier``: ansj's optional NumRecognition pass —
    an adjacent numeral + measure-word pair fuses into one token
    (三 + 点 -> 三点), matching ansj's 数量词合并 recognition."""
    dic, max_w = merged if merged is not None else merge_entries(user_entries)

    text = unicodedata.normalize("NFKC", text)
    n = len(text)
    if n == 0:
        return []
    best = [dict() for _ in range(n + 1)]
    best[0] = {UNK: (0.0, -1, -1, "")}  # BOS

    for i in range(n):
        if not best[i]:
            continue
        cands = []
        upper = min(n, i + max_w)
        for j in range(i + 1, upper + 1):
            for cost, cls in dic.get(text[i:j], ()):
                cands.append((text[i:j], cost, cls))
        cands.extend(_rule_candidates(text, i, dic))
        for surface, wcost, cls in cands:
            j = i + len(surface)
            for pcls, (pcost, *_r) in best[i].items():
                conn = _BOS_COST.get(cls, 0) if i == 0 else _conn(pcls, cls)
                total = pcost + wcost + conn
                cur = best[j].get(cls)
                if cur is None or total < cur[0]:
                    best[j][cls] = (total, i, pcls, surface)

    if not best[n]:
        return [text]
    cls = min(best[n], key=lambda c: best[n][c][0])
    pos = n
    toks = []
    while pos > 0:
        _, prev, pcls, surface = best[pos][cls]
        toks.append((surface, cls))
        pos, cls = prev, pcls
    toks.reverse()
    if merge_num_quantifier:
        merged_toks, i = [], 0
        while i < len(toks):
            if (i + 1 < len(toks) and toks[i][1] == NUM
                    and toks[i + 1][1] == MEAS):
                merged_toks.append((toks[i][0] + toks[i + 1][0], NUM))
                i += 2
            else:
                merged_toks.append(toks[i])
                i += 1
        toks = merged_toks
    return [t for t, _c in toks if t.strip()]
