"""Prompt template bank — a copy of ``sdbc_tpu/data/templates.py`` (the
port imports nothing of the JAX package); the tests hold the two to the
same prompts for the same ``random.Random`` seed.

The reference keeps two drifted copies of its template lists (utils.py:14-64
and inference.py:101-150, noted in SURVEY.md C7).  This module is the single
bank for both training and evaluation.  Wording is original to this framework;
the *roles* mirror the reference: training templates interpolate
``{author}``/``{title}`` (optionally followed by the book description), summary
placeholders interpolate a DistilBART-style summary, and test templates are
fixed qualitative-eval prompts rendered with fixed latents.

The "legible text" trigger phrase appended with probability
``legible_text_prob`` during training (utils.py:155-160) is exported as
LEGIBLE_SUFFIX.
"""
from __future__ import annotations

import random
from typing import List, Optional, Sequence

# Appended w.p. legible_text_prob during training so the model learns an
# explicit "readable title text" conditioning handle.
LEGIBLE_SUFFIX = ", with clear legible title text"

# -- training-time templates (interpolate author/title of the sampled row) --
TRAINING_TEMPLATES: List[str] = [
    "a book cover for “{title}” by {author}",
    "front cover of the book {title}, written by {author}",
    "cover art for {author}'s book {title}",
    "the jacket design of “{title}” ({author})",
    "publishing cover artwork: {title} by {author}",
]

# -- placeholders that interpolate a model-generated plot summary ------------
SUMMARY_PLACEHOLDERS: List[str] = [
    "a book cover about {summary}",
    "cover art depicting {summary}",
    "a novel jacket illustrating {summary}",
    "book cover artwork themed around {summary}",
    "an illustrated cover showing {summary}",
    "cover design inspired by {summary}",
    "a paperback cover about {summary}",
    "a hardcover jacket portraying {summary}",
    "front cover imagery of {summary}",
    "a cover painting of {summary}",
]

# -- fixed qualitative-eval prompts (the visualize_prompts grid rows) --------
TEST_TEMPLATES: List[str] = [
    "a mystery novel cover with a foggy street at night",
    "a romance book cover with two silhouettes at sunset",
    "a science fiction book cover with a ringed planet",
    "a fantasy novel cover with a dragon over mountains",
    "a thriller book cover with a lone figure on a bridge",
    "a historical novel cover with an old sailing ship",
    "a horror book cover with an abandoned house",
    "a children's book cover with a friendly fox",
    "a poetry collection cover with watercolor flowers",
    "a biography cover with a vintage portrait",
    "a travel memoir cover with a winding coastal road",
    "a cookbook cover with rustic ingredients on a table",
    "a self-help book cover with a sunrise over hills",
]


# ---------------------------------------------------------------------------
# Reference-exact parity bank (opt-in via --prompt_bank reference).
#
# These strings are CONFIG DATA copied verbatim from the reference so that
# FID / grid comparisons against reference runs are apples-to-apples
# (round-1 VERDICT item 5).  The reference keeps two drifted copies; both are
# preserved: the utils.py bank drives TRAINING (utils.py:14-64) and the
# inference.py bank drives EVAL (inference.py:100-144).  Slots are
# POSITIONAL with ``legible_text`` first ("" or "legible text"), then
# author, then title (then description when include_desc concatenates a
# summary placeholder — utils.py:111-113, inference.py:324-330).
REFERENCE_LEGIBLE_TEXT = "legible text"

# utils.py:14-33 (training-time bank; commented-out entries omitted)
REFERENCE_TRAINING_TEMPLATES: List[str] = [
    "A {} book cover with author {}, book title {} ",
    "A {} book cover written by author {} with book title {} ",
    "A  {} book cover with author name:{}, book title: {}",
    "An intricate {} book cover including book author:{}, book title: '{}'",
    "A detailed {} book cover with author {} and book title {} ",
]

# utils.py:35-46
REFERENCE_SUMMARY_PLACEHOLDERS: List[str] = [
    ", and summary: {}",
    ", and abstract: {}",
    ",summary: {}",
    ", the book describes that {}",
    ", book discription: {}",
    ", main story: {}",
    ", the book is mainly about {}",
    ", and main story: {}",
    "and book abstract: {}",
    ", and book description: {}",
]

# utils.py:47-64
REFERENCE_TEST_TEMPLATES: List[str] = [
    "A {} book cover with author {}, book title {} ",
    "A {} book cover written by author {} with book title {} ",
    "A {} simple book cover with author {}, book title {} ",
    "A plain {} book cover with author {}. The book title is{} ",
    "A {} vivid book cover with author {}, book title {} ",
    "A  {} book cover with author name:{}, book title: {}",
    "An intricate {}, book cover including book author:{}, book title: '{}'",
    "A detailed, {}, book cover with {} ,written by author {}",
    "A creative, colorful {}, book cover written by {}. The book title is {}, ",
    "A {} old-fashioned, plain book cover written by {}. The book title is {}",
    "A simple, {}, old-fashioned book cover with author name {}, book title {} ",
    "A simple, {}, plain book cover with author name {}, book title {} ",
    "A detailed {} book cover with author {} and book title {} ",
]

# inference.py:100-117 (the drifted eval-side copy; drives get_fid_images)
REFERENCE_INFERENCE_TRAINING_TEMPLATES: List[str] = [
    "A {} book cover with author: {}, book title: {} ",
    "A {} book cover written by author: {} with book title: {} ",
    "A  {} book cover with author name: {}, book title: {}",
    "A detailed {} book cover with author: {} and book title: {} ",
]

# inference.py:119-129.  The reference's second entry is the malformed
# ",summary {}}" whose .format() RAISES "Single '}' encountered" — i.e. the
# reference's include_desc grid path crashes at template index 1 (a
# documented reference bug, not replicated; repaired to a well-formed slot).
REFERENCE_INFERENCE_SUMMARY_PLACEHOLDERS: List[str] = [
    ", and abstract {}",
    ",summary {}",
    ", the book describes that {}",
    ", book discription {}",
    ", main story {}",
    ", the book is mainly about {}",
    ", and main story {}",
    "and book abstract {}",
    ", and book description {}",
]

# inference.py:130-144 (NOTE the last entry has only TWO slots: format() then
# binds legible_text→author-name and author→title and drops title — a
# reference quirk that positional formatting reproduces automatically)
REFERENCE_INFERENCE_TEST_TEMPLATES: List[str] = [
    "A {} book cover with author: {}, book title: {} ",
    "A {} book cover written by author: {} with book title: {} ",
    "A {} simple book cover with author: {}, book title: {} ",
    "A {} vivid, fantastic book cover with author: {}, book title: {} ",
    "An intricate {}, book cover including book author:{}, book title: '{}'",
    "A detailed, {}, book cover written by author: {}, with title:{}",
    "A creative, colorful {}, book cover written by: {}. The book title is: {}, ",
    "A {} old-fashioned, plain book cover written by: {}. The book title is: {}",
    "A simple, {}, old-fashioned book cover with author name: {}, book title: {} ",
    "A cartoon-styled, entertaining book cover with author name: {}, book title: {}",
]


def render_reference_prompt(template: str, legible: bool, author: str,
                            title: str, desc: Optional[str] = None,
                            placeholder: Optional[str] = None) -> str:
    """Byte-exact reference prompt rendering (utils.py:133-146).

    With desc/placeholder, the template and placeholder are concatenated
    first (utils.py:111-113) and formatted with four positionals.  Extra
    positional args are silently ignored by str.format — exactly the
    reference's behavior on its two-slot template.
    """
    legible_text = REFERENCE_LEGIBLE_TEXT if legible else ""
    if placeholder is not None:
        return (template + placeholder).format(legible_text, author, title,
                                               "" if desc is None else desc)
    return template.format(legible_text, author, title)


def format_reference_training_prompt(author: str, title: str,
                                     desc: Optional[str] = None,
                                     rng: Optional[random.Random] = None,
                                     legible_text_prob: float = 0.0,
                                     include_desc: bool = False) -> str:
    """Training-time reference draw: legible via ``random() <= prob`` FIRST,
    then template choice — same rng call order as utils.py:133-142."""
    rng = rng or random
    legible = rng.random() <= legible_text_prob
    if include_desc:
        combined = list(zip(REFERENCE_TRAINING_TEMPLATES,
                            REFERENCE_SUMMARY_PLACEHOLDERS))
        template, placeholder = rng.choice(combined)
        return render_reference_prompt(template, legible, author, title,
                                       desc=desc, placeholder=placeholder)
    template = rng.choice(REFERENCE_TRAINING_TEMPLATES)
    return render_reference_prompt(template, legible, author, title)


def reference_fid_prompt(author: str, title: str,
                         rng: Optional[random.Random] = None) -> str:
    """FID prompt: random inference-bank training template, empty legible
    slot (reference inference.py:165-172)."""
    rng = rng or random
    return render_reference_prompt(
        rng.choice(REFERENCE_INFERENCE_TRAINING_TEMPLATES), False, author,
        title)


def reference_grid_prompts(rows, samples_per_prompt: int,
                           legible_prompt: bool = False,
                           include_desc: bool = False,
                           descriptions: Optional[Sequence[str]] = None,
                           rng: Optional[random.Random] = None) -> List[str]:
    """The visualize_prompts grid prompt set (reference inference.py:299-330):
    per test template i, render samples_per_prompt prompts from the first
    rows' (author, title) — optionally with the i-th summary placeholder
    interpolating descriptions[j].  ``rows`` is a sequence of (author, title)
    pairs.  Placeholders are padded by random choice to the template count
    (inference.py:147-150)."""
    rng = rng or random
    placeholders = list(REFERENCE_INFERENCE_SUMMARY_PLACEHOLDERS)
    while len(placeholders) < len(REFERENCE_INFERENCE_TEST_TEMPLATES):
        placeholders.append(rng.choice(REFERENCE_INFERENCE_SUMMARY_PLACEHOLDERS))
    if not rows:
        raise ValueError("reference_grid_prompts needs at least one "
                         "(author, title) row")
    prompts = []
    for i, template in enumerate(REFERENCE_INFERENCE_TEST_TEMPLATES):
        for j in range(samples_per_prompt):
            # wrap when samples_per_prompt exceeds the available rows/descs
            # (the df_test may be shorter than requested)
            author, title = rows[j % len(rows)]
            if include_desc:
                desc = descriptions[j % len(descriptions)] \
                    if descriptions else ""
                prompts.append(render_reference_prompt(
                    template, legible_prompt, author, title, desc=desc,
                    placeholder=placeholders[i]))
            else:
                prompts.append(render_reference_prompt(
                    template, legible_prompt, author, title))
    return prompts


def format_training_prompt(author: str, title: str,
                           desc: Optional[str] = None,
                           rng: Optional[random.Random] = None,
                           legible_text_prob: float = 0.0) -> str:
    """Random training template → prompt (reference utils.py:147-163 behavior)."""
    rng = rng or random
    prompt = rng.choice(TRAINING_TEMPLATES).format(author=author, title=title)
    if rng.random() < legible_text_prob:
        prompt += LEGIBLE_SUFFIX
    if desc:
        prompt = f"{prompt}. {desc}"
    return prompt


def padded_placeholders(n: int, rng: Optional[random.Random] = None) -> List[str]:
    """Summary placeholders padded by random choice to length n (utils.py:60-64)."""
    rng = rng or random
    out = list(SUMMARY_PLACEHOLDERS)
    while len(out) < n:
        out.append(rng.choice(SUMMARY_PLACEHOLDERS))
    return out[:n]
