"""BEAST2 input-XML export for cross-validation runs.

Reference: core/beasty_input.cpp export_beast_2_6_2_input (lines 200-560) —
the engine emits an equivalent BEAST2 configuration (same alignment, tip
dates, HKY model, strict clock, exponential-growth coalescent, matching
priors) so posteriors can be compared run-for-run (whitepaper §5).  This
writer targets BEAST 2.6; tip times use linear years measured like BEAST's.
"""

from __future__ import annotations

import numpy as np

from .. import seq as seqm
from ..dates import to_linear_year
from ..phylo import FlatTree


def _xml_escape(s: str) -> str:
    return (s.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")
            .replace('"', "&quot;"))


def export_beast2_xml(fh, tree: FlatTree, run, chain_length: int = 10_000_000,
                      log_every: int = 10_000):
    """Write a BEAST2 2.6-style XML for the dataset held by `run`."""
    T = tree.num_tips
    L = tree.num_sites
    hyp = run.hyp
    hv = run.host_view()

    fh.write('<?xml version="1.0" encoding="UTF-8" standalone="no"?>\n')
    fh.write("<beast beautitemplate='Standard' beautistatus='' "
             'namespace="beast.core:beast.evolution.alignment:'
             'beast.evolution.tree.coalescent:beast.core.util:'
             'beast.evolution.nuc:beast.evolution.operators:'
             'beast.evolution.sitemodel:beast.evolution.substitutionmodel:'
             'beast.evolution.likelihood" required="" version="2.6">\n\n')

    # alignment (sequences reconstructed from the EMAT; missing sites as N)
    fh.write('  <data id="input_alignment" spec="Alignment" name="alignment">\n')
    for i in range(T):
        s = tree.sequence_at(i)
        chars = np.array(list(seqm.real_to_str(s)))
        for l in sorted(tree.missing_sites_at(i)):
            chars[l] = "N"
        fh.write(f'    <sequence id="seq_{_xml_escape(tree.name[i])}" '
                 f'spec="Sequence" taxon="{_xml_escape(tree.name[i])}" '
                 f'totalcount="4" value="{"".join(chars)}"/>\n')
    fh.write("  </data>\n\n")

    fh.write(f'  <run id="mcmc" spec="MCMC" chainLength="{chain_length}">\n')
    fh.write('    <state id="state" spec="State" storeEvery="5000">\n')
    fh.write('      <tree id="Tree.t:input_alignment" spec="beast.evolution.tree.Tree" name="stateNode">\n')
    fh.write('        <trait id="dateTrait.t:input_alignment" spec="beast.evolution.tree.TraitSet" traitname="date" value="')
    fh.write(",".join(f"{_xml_escape(tree.name[i])}={to_linear_year(float(tree.t[i])):.8f}"
                      for i in range(T)))
    fh.write('">\n')
    fh.write('          <taxa id="TaxonSet.input_alignment" spec="TaxonSet" alignment="@input_alignment"/>\n')
    fh.write("        </trait>\n")
    fh.write('        <taxonset idref="TaxonSet.input_alignment"/>\n')
    fh.write("      </tree>\n")
    mu_per_year = float(hv.evo.mu) * 365.0
    fh.write(f'      <parameter id="clockRate.c:input_alignment" spec="parameter.RealParameter" name="stateNode">{mu_per_year:.8g}</parameter>\n')
    fh.write(f'      <parameter id="kappa.s:input_alignment" spec="parameter.RealParameter" lower="0.0" name="stateNode">{float(hv.evo.kappa):.8g}</parameter>\n')
    if hyp.alpha_move_enabled:
        fh.write(f'      <parameter id="gammaShape.s:input_alignment" spec="parameter.RealParameter" name="stateNode">{float(hv.evo.alpha):.8g}</parameter>\n')
    n0_years = float(hv.pop.n0) / 365.0
    g_years = float(hv.pop.g) * 365.0
    fh.write(f'      <parameter id="ePopSize.t:input_alignment" spec="parameter.RealParameter" name="stateNode">{n0_years:.8g}</parameter>\n')
    fh.write(f'      <parameter id="growthRate.t:input_alignment" spec="parameter.RealParameter" name="stateNode">{g_years:.8g}</parameter>\n')
    pi = hv.evo.pi
    fh.write(f'      <parameter id="freqParameter.s:input_alignment" spec="parameter.RealParameter" dimension="4" lower="0.0" upper="1.0" name="stateNode">{pi[0]:.6g} {pi[1]:.6g} {pi[2]:.6g} {pi[3]:.6g}</parameter>\n')
    fh.write("    </state>\n\n")

    fh.write('    <init id="RandomTree.t:input_alignment" spec="beast.evolution.tree.RandomTree" estimate="false" initial="@Tree.t:input_alignment" taxa="@input_alignment">\n')
    fh.write('      <populationModel id="ConstantPopulation0.t:input_alignment" spec="ConstantPopulation">\n')
    fh.write('        <parameter id="randomPopSize.t:input_alignment" spec="parameter.RealParameter" name="popSize">1.0</parameter>\n')
    fh.write("      </populationModel>\n    </init>\n\n")

    fh.write('    <distribution id="posterior" spec="util.CompoundDistribution">\n')
    fh.write('      <distribution id="prior" spec="util.CompoundDistribution">\n')
    fh.write('        <distribution id="CoalescentExponential.t:input_alignment" spec="Coalescent">\n')
    fh.write('          <populationModel id="ExponentialGrowth.t:input_alignment" spec="ExponentialGrowth" growthRate="@growthRate.t:input_alignment" popSize="@ePopSize.t:input_alignment"/>\n')
    fh.write('          <treeIntervals id="TreeIntervals.t:input_alignment" spec="TreeIntervals" tree="@Tree.t:input_alignment"/>\n')
    fh.write("        </distribution>\n")
    fh.write('        <prior id="ClockPrior.c:input_alignment" name="distribution" x="@clockRate.c:input_alignment">\n')
    fh.write('          <Uniform id="Uniform.0" name="distr" upper="Infinity"/>\n')
    fh.write("        </prior>\n")
    fh.write('        <prior id="KappaPrior.s:input_alignment" name="distribution" x="@kappa.s:input_alignment">\n')
    fh.write(f'          <LogNormal id="LogNormalDistributionModel.0" name="distr" M="{hyp.kappa_prior_mean_log}" S="{hyp.kappa_prior_sigma_log}"/>\n')
    fh.write("        </prior>\n")
    if hyp.alpha_move_enabled:
        fh.write('        <prior id="GammaShapePrior.s:input_alignment" name="distribution" x="@gammaShape.s:input_alignment">\n')
        fh.write('          <Exponential id="Exponential.0" name="distr"/>\n')
        fh.write("        </prior>\n")
    fh.write('        <prior id="ePopSizePrior.t:input_alignment" name="distribution" x="@ePopSize.t:input_alignment">\n')
    fh.write('          <OneOnX id="OneOnX.1" name="distr"/>\n')
    fh.write("        </prior>\n")
    fh.write('        <prior id="GrowthRatePrior.t:input_alignment" name="distribution" x="@growthRate.t:input_alignment">\n')
    fh.write(f'          <LaplaceDistribution id="Laplace.0" name="distr" mu="{hyp.pop_g_prior_mu * 365.0}" scale="{hyp.pop_g_prior_scale * 365.0}"/>\n')
    fh.write("        </prior>\n")
    fh.write("      </distribution>\n")
    fh.write('      <distribution id="likelihood" spec="util.CompoundDistribution" useThreads="true">\n')
    fh.write('        <distribution id="treeLikelihood.input_alignment" spec="ThreadedTreeLikelihood" data="@input_alignment" tree="@Tree.t:input_alignment">\n')
    fh.write('          <siteModel id="SiteModel.s:input_alignment" spec="SiteModel"')
    if hyp.alpha_move_enabled:
        fh.write(' gammaCategoryCount="4" shape="@gammaShape.s:input_alignment"')
    fh.write(">\n")
    fh.write('            <parameter id="mutationRate.s:input_alignment" spec="parameter.RealParameter" estimate="false" name="mutationRate">1.0</parameter>\n')
    fh.write('            <parameter id="proportionInvariant.s:input_alignment" spec="parameter.RealParameter" estimate="false" lower="0.0" name="proportionInvariant" upper="1.0">0.0</parameter>\n')
    fh.write('            <substModel id="hky.s:input_alignment" spec="HKY" kappa="@kappa.s:input_alignment">\n')
    fh.write('              <frequencies id="estimatedFreqs.s:input_alignment" spec="Frequencies" frequencies="@freqParameter.s:input_alignment"/>\n')
    fh.write("            </substModel>\n          </siteModel>\n")
    fh.write('          <branchRateModel id="StrictClock.c:input_alignment" spec="beast.evolution.branchratemodel.StrictClockModel" clock.rate="@clockRate.c:input_alignment"/>\n')
    fh.write("        </distribution>\n      </distribution>\n    </distribution>\n\n")

    # operators (beasty_input.cpp:449-500)
    W = [
        '<operator id="StrictClockRateScaler.c:input_alignment" spec="ScaleOperator" parameter="@clockRate.c:input_alignment" scaleFactor="0.75" weight="3.0"/>',
        '<operator id="KappaScaler.s:input_alignment" spec="ScaleOperator" parameter="@kappa.s:input_alignment" scaleFactor="0.5" weight="0.1"/>',
        '<operator id="CoalescentExponentialTreeScaler.t:input_alignment" spec="ScaleOperator" scaleFactor="0.5" tree="@Tree.t:input_alignment" weight="3.0"/>',
        '<operator id="CoalescentExponentialTreeRootScaler.t:input_alignment" spec="ScaleOperator" rootOnly="true" scaleFactor="0.5" tree="@Tree.t:input_alignment" weight="3.0"/>',
        '<operator id="CoalescentExponentialUniformOperator.t:input_alignment" spec="Uniform" tree="@Tree.t:input_alignment" weight="30.0"/>',
        '<operator id="CoalescentExponentialSubtreeSlide.t:input_alignment" spec="SubtreeSlide" tree="@Tree.t:input_alignment" weight="15.0"/>',
        '<operator id="CoalescentExponentialNarrow.t:input_alignment" spec="Exchange" tree="@Tree.t:input_alignment" weight="15.0"/>',
        '<operator id="CoalescentExponentialWide.t:input_alignment" spec="Exchange" isNarrow="false" tree="@Tree.t:input_alignment" weight="3.0"/>',
        '<operator id="CoalescentExponentialWilsonBalding.t:input_alignment" spec="WilsonBalding" tree="@Tree.t:input_alignment" weight="3.0"/>',
        '<operator id="ePopSizeScaler.t:input_alignment" spec="ScaleOperator" parameter="@ePopSize.t:input_alignment" scaleFactor="0.75" weight="3.0"/>',
        '<operator id="GrowthRateRandomWalk.t:input_alignment" spec="RealRandomWalkOperator" parameter="@growthRate.t:input_alignment" weight="3.0" windowSize="1.0"/>',
    ]
    if hyp.alpha_move_enabled:
        W.append('<operator id="gammaShapeScaler.s:input_alignment" spec="ScaleOperator" parameter="@gammaShape.s:input_alignment" scaleFactor="0.5" weight="0.1"/>')
    for w in W:
        fh.write(f"    {w}\n")
    fh.write('    <operator id="FrequenciesExchanger.s:input_alignment" spec="DeltaExchangeOperator" delta="0.01" weight="0.1">\n')
    fh.write('      <parameter idref="freqParameter.s:input_alignment"/>\n    </operator>\n\n')

    fh.write(f'    <logger id="tracelog" spec="Logger" fileName="beast_run.log" logEvery="{log_every}" model="@posterior" sanitiseHeaders="true" sort="smart">\n')
    for ref in ("posterior", "likelihood", "prior", "treeLikelihood.input_alignment"):
        fh.write(f'      <log idref="{ref}"/>\n')
    fh.write('      <log id="TreeHeight.t:input_alignment" spec="beast.evolution.tree.TreeHeightLogger" tree="@Tree.t:input_alignment"/>\n')
    for ref in ("clockRate.c:input_alignment", "kappa.s:input_alignment",
                "CoalescentExponential.t:input_alignment",
                "ePopSize.t:input_alignment", "growthRate.t:input_alignment",
                "freqParameter.s:input_alignment"):
        fh.write(f'      <log idref="{ref}"/>\n')
    if hyp.alpha_move_enabled:
        fh.write('      <log idref="gammaShape.s:input_alignment"/>\n')
    fh.write("    </logger>\n")
    fh.write('    <logger id="screenlog" spec="Logger" logEvery="50000">\n'
             '      <log idref="posterior"/>\n      <log idref="likelihood"/>\n'
             '      <log idref="prior"/>\n    </logger>\n')
    fh.write(f'    <logger id="treelog.t:input_alignment" spec="Logger" fileName="beast_run.trees" logEvery="{log_every}" mode="tree">\n')
    fh.write('      <log id="TreeWithMetaDataLogger.t:input_alignment" spec="beast.evolution.tree.TreeWithMetaDataLogger" tree="@Tree.t:input_alignment"/>\n')
    fh.write("    </logger>\n")
    fh.write('    <operatorschedule id="OperatorSchedule" spec="OperatorSchedule"/>\n')
    fh.write("  </run>\n</beast>\n")


def export_beast2_7_xml(fh, tree: FlatTree, run, chain_length: int = 10_000_000,
                        log_every: int = 10_000, tree_every: int = 10_000):
    """Write a BEAST2 2.7.7-style XML (reference export_beast_2_7_7_input,
    core/beasty_input.cpp:563-1001): beast.base namespaces + name-alias maps,
    ISO tip dates in the TraitSet (dateFormat yyyy-M-dd), BEAUti-default
    initial parameter values, Dirichlet frequency prior, tip-date-sampling
    MRCAPriors/TipDatesRandomWalkers for uncertain tips, and the 2.7.7
    operator set (AdaptableOperatorSampler + AVMN + Bactrian kernels +
    BICEPS epoch operators).  Priors match Delphy's (Laplace growth-rate
    scale stays 30.701135, gammaShape keeps no lower bound — see the
    reference's notes at beasty_input.cpp:599-661)."""
    from ..dates import to_iso_date
    from .. import pop as popm

    if getattr(run, "mpox_hack", False):
        raise ValueError("BEAST XML export not supported with the mpox hack "
                         "(matches the reference's limitation)")
    if isinstance(run.pop, popm.SkygridPopParams):
        # the reference emits an intentionally-invalid <ERROR> tag here
        # (beasty_input.cpp:712-717); fail fast instead
        raise ValueError("BEAST2 doesn't implement a Skygrid model")

    T = tree.num_tips
    hyp = run.hyp
    hv = run.host_view()
    mu_move = hyp.mu_move_enabled and not hyp.mu_fixed
    alpha_move = hyp.alpha_move_enabled
    pop_size_move = hyp.pop_size_move_enabled
    pop_g_move = hyp.pop_growth_rate_move_enabled
    import math as _math

    fh.write('<?xml version="1.0" encoding="UTF-8" standalone="no"?>\n\n')
    fh.write('<!-- BEAST2 v2.7.7 input file generated by delphy-tpu for '
             'cross-validation -->\n\n')
    fh.write("<beast beautitemplate='Standard' beautistatus='' "
             'namespace="beast.core:beast.evolution.alignment:'
             'beast.evolution.tree.coalescent:beast.core.util:'
             'beast.evolution.nuc:beast.evolution.operators:'
             'beast.evolution.sitemodel:beast.evolution.substitutionmodel:'
             'beast.base.evolution.alignment:beast.pkgmgmt:beast.base.core:'
             'beast.base.inference:beast.base.evolution.tree.coalescent:'
             'beast.pkgmgmt:beast.base.core:beast.base.inference.util:'
             'beast.evolution.nuc:beast.base.evolution.operator:'
             'beast.base.inference.operator:beast.base.evolution.sitemodel:'
             'beast.base.evolution.substitutionmodel:'
             'beast.base.evolution.likelihood" '
             'required="BEAST.base v2.7.7" version="2.7">\n\n')

    # alignment (sequences reconstructed from the EMAT; missing sites as N)
    fh.write('  <data id="input_alignment" spec="Alignment" name="alignment">\n')
    for i in range(T):
        s = tree.sequence_at(i)
        chars = np.array(list(seqm.real_to_str(s)))
        for l in sorted(tree.missing_sites_at(i)):
            chars[l] = "N"
        fh.write(f'    <sequence id="seq_{_xml_escape(tree.name[i])}" '
                 f'spec="Sequence" taxon="{_xml_escape(tree.name[i])}" '
                 f'totalcount="4" value="{"".join(chars)}"/>\n')
    fh.write("  </data>\n\n")

    # name aliases (2.7 moved distributions under beast.base.inference)
    for alias, cls in (("Uniform", "Uniform"), ("Exponential", "Exponential"),
                       ("LogNormal", "LogNormalDistributionModel"),
                       ("Normal", "Normal"), ("Beta", "Beta"),
                       ("Gamma", "Gamma"),
                       ("LaplaceDistribution", "LaplaceDistribution"),
                       ("prior", "Prior"), ("InverseGamma", "InverseGamma"),
                       ("OneOnX", "OneOnX")):
        fh.write(f'  <map name="{alias}" >beast.base.inference.distribution.'
                 f'{cls}</map>\n')
    fh.write("\n")

    fh.write(f'  <run id="mcmc" spec="MCMC" chainLength="{chain_length}">\n')
    fh.write('    <state id="state" spec="State" storeEvery="5000">\n')
    fh.write('      <tree id="Tree.t:input_alignment" spec="beast.base.evolution.tree.Tree" name="stateNode">\n')
    fh.write('        <trait id="dateTrait.t:input_alignment" spec="beast.base.evolution.tree.TraitSet" dateFormat="yyyy-M-dd" traitname="date" value="')
    fh.write(",".join(
        f"{_xml_escape(tree.name[i])}="
        f"{to_iso_date(0.5 * (float(tree.t_min[i]) + float(tree.t_max[i])))}"
        for i in range(T)))
    fh.write('">\n')
    fh.write('          <taxa id="TaxonSet.input_alignment" spec="TaxonSet">\n'
             '            <alignment idref="input_alignment"/>\n'
             "          </taxa>\n")
    fh.write("        </trait>\n")
    fh.write('        <taxonset idref="TaxonSet.input_alignment"/>\n')
    fh.write("      </tree>\n")
    # initial values are BEAUti2 defaults, as in the reference (the chain
    # burns in from scratch either way; beasty_input.cpp:657-675)
    if mu_move:
        fh.write('      <parameter id="clockRate.c:input_alignment" spec="parameter.RealParameter" lower="0.0" name="stateNode">1.0</parameter>\n')
    if alpha_move:
        # no lower bound, matching Delphy/2.6.2 (beasty_input.cpp:661)
        fh.write('      <parameter id="gammaShape.s:input_alignment" spec="parameter.RealParameter" name="stateNode">1.0</parameter>\n')
    fh.write('      <parameter id="kappa.s:input_alignment" spec="parameter.RealParameter" lower="0.0" name="stateNode">2.0</parameter>\n')
    if pop_size_move:
        fh.write('      <parameter id="ePopSize.t:input_alignment" spec="parameter.RealParameter" lower="0.0" name="stateNode">0.3</parameter>\n')
    if pop_g_move:
        bounds = ""
        if _math.isfinite(hyp.pop_g_min):
            bounds += f' lower="{hyp.pop_g_min * 365.0:g}"'
        if _math.isfinite(hyp.pop_g_max):
            bounds += f' upper="{hyp.pop_g_max * 365.0:g}"'
        fh.write(f'      <parameter id="growthRate.t:input_alignment" spec="parameter.RealParameter"{bounds} name="stateNode">3.0E-4</parameter>\n')
    fh.write('      <parameter id="freqParameter.s:input_alignment" spec="parameter.RealParameter" dimension="4" lower="0.0" name="stateNode" upper="1.0">0.25</parameter>\n')
    fh.write("    </state>\n\n")

    fh.write('    <init id="RandomTree.t:input_alignment" spec="RandomTree" estimate="false" initial="@Tree.t:input_alignment" taxa="@input_alignment">\n')
    fh.write('      <populationModel id="ConstantPopulation0.t:input_alignment" spec="ConstantPopulation">\n')
    fh.write('        <parameter id="randomPopSize.t:input_alignment" spec="parameter.RealParameter" name="popSize">1.0</parameter>\n')
    fh.write("      </populationModel>\n    </init>\n\n")

    fh.write('    <distribution id="posterior" spec="CompoundDistribution">\n')
    fh.write('      <distribution id="prior" spec="CompoundDistribution">\n')
    fh.write('        <distribution id="Coalescent.t:input_alignment" spec="Coalescent">\n')
    g_ref = ('"@growthRate.t:input_alignment"' if pop_g_move
             else f'"{float(hv.pop.g) * 365.0:g}"')
    n0_ref = ('"@ePopSize.t:input_alignment"' if pop_size_move
              else f'"{float(hv.pop.n0) / 365.0:g}"')
    fh.write(f'          <populationModel id="ExponentialGrowth.t:input_alignment" spec="ExponentialGrowth" growthRate={g_ref} popSize={n0_ref}/>\n')
    fh.write('          <treeIntervals id="TreeIntervals.t:input_alignment" spec="beast.base.evolution.tree.TreeIntervals" tree="@Tree.t:input_alignment"/>\n')
    fh.write("        </distribution>\n")
    if mu_move:
        fh.write('        <prior id="ClockPrior.c:input_alignment" name="distribution" x="@clockRate.c:input_alignment">\n')
        if hyp.mu_prior_alpha != 1.0 or hyp.mu_prior_beta != 0.0:
            fh.write('          <Gamma id="Gamma.clockRate" name="distr" mode="ShapeRate">\n')
            fh.write(f'            <parameter id="RealParameter.clockRate.alpha" spec="parameter.RealParameter" estimate="false" name="alpha">{hyp.mu_prior_alpha:g}</parameter>\n')
            fh.write(f'            <parameter id="RealParameter.clockRate.beta" spec="parameter.RealParameter" estimate="false" name="beta">{hyp.mu_prior_beta / 365.0:g}</parameter>\n')
            fh.write("          </Gamma>\n")
        else:
            fh.write('          <Uniform id="Uniform.0" name="distr" upper="Infinity"/>\n')
        fh.write("        </prior>\n")
    if pop_size_move:
        fh.write('        <prior id="ePopSizePrior.t:input_alignment" name="distribution" x="@ePopSize.t:input_alignment">\n')
        if hyp.pop_inv_n0_prior_alpha != 0.0 or hyp.pop_inv_n0_prior_beta != 0.0:
            fh.write('          <InverseGamma id="InverseGamma.popSize" name="distr">\n')
            fh.write(f'            <parameter id="RealParameter.popSize.alpha" spec="parameter.RealParameter" estimate="false" name="alpha">{hyp.pop_inv_n0_prior_alpha:g}</parameter>\n')
            fh.write(f'            <parameter id="RealParameter.popSize.beta" spec="parameter.RealParameter" estimate="false" name="beta">{hyp.pop_inv_n0_prior_beta / 365.0:g}</parameter>\n')
            fh.write("          </InverseGamma>\n")
        else:
            fh.write('          <OneOnX id="OneOnX.1" name="distr"/>\n')
        fh.write("        </prior>\n")
    fh.write('        <prior id="FrequenciesPrior.s:input_alignment" name="distribution" x="@freqParameter.s:input_alignment">\n')
    fh.write('          <distr id="Dirichlet.0" spec="distribution.Dirichlet">\n')
    fh.write('            <parameter id="RealParameter.5" spec="parameter.RealParameter" dimension="4" estimate="false" name="alpha">4.0 4.0 4.0 4.0</parameter>\n')
    fh.write("          </distr>\n        </prior>\n")
    if alpha_move:
        fh.write('        <prior id="GammaShapePrior.s:input_alignment" name="distribution" x="@gammaShape.s:input_alignment">\n')
        fh.write('          <Exponential id="Exponential.0" name="distr">\n')
        fh.write('            <parameter id="RealParameter.0" spec="parameter.RealParameter" estimate="false" name="mean">1</parameter>\n')
        fh.write("          </Exponential>\n        </prior>\n")
    if pop_g_move:
        fh.write('        <prior id="GrowthRatePrior.t:input_alignment" name="distribution" x="@growthRate.t:input_alignment">\n')
        fh.write('          <LaplaceDistribution id="LaplaceDistribution.0" name="distr">\n')
        fh.write(f'            <parameter id="RealParameter.3" spec="parameter.RealParameter" estimate="false" name="mu">{hyp.pop_g_prior_mu * 365.0:g}</parameter>\n')
        fh.write(f'            <parameter id="RealParameter.4" spec="parameter.RealParameter" estimate="false" name="scale">{hyp.pop_g_prior_scale * 365.0:g}</parameter>\n')
        fh.write("          </LaplaceDistribution>\n        </prior>\n")
    fh.write('        <prior id="KappaPrior.s:input_alignment" name="distribution" x="@kappa.s:input_alignment">\n')
    fh.write('          <LogNormal id="LogNormalDistributionModel.0" name="distr">\n')
    fh.write(f'            <parameter id="RealParameter.1" spec="parameter.RealParameter" estimate="false" name="M">{hyp.kappa_prior_mean_log:g}</parameter>\n')
    fh.write(f'            <parameter id="RealParameter.2" spec="parameter.RealParameter" estimate="false" name="S">{hyp.kappa_prior_sigma_log:g}</parameter>\n')
    fh.write("          </LogNormal>\n        </prior>\n")
    # tip-date sampling priors (beasty_input.cpp:808-830)
    uncertain = [i for i in range(T)
                 if float(tree.t_min[i]) != float(tree.t_max[i])]
    for i in uncertain:
        name = _xml_escape(tree.name[i])
        fh.write(f'        <distribution id="tip-dist.{name}" spec="beast.base.evolution.tree.MRCAPrior" tipsonly="true" tree="@Tree.t:input_alignment">\n')
        fh.write(f'          <taxonset id="tip-taxonset.{name}" spec="TaxonSet">\n')
        fh.write(f'            <taxon id="{name}" spec="Taxon"/>\n')
        fh.write("          </taxonset>\n")
        # %.5f precision matters: consecutive dates collapse under %g
        fh.write(f'          <Uniform id="tip-uniform.{name}" name="distr" lower="{to_linear_year(float(tree.t_min[i])):.5f}" upper="{to_linear_year(float(tree.t_max[i])):.5f}"/>\n')
        fh.write("        </distribution>\n")
    fh.write("      </distribution>\n")

    fh.write('      <distribution id="likelihood" spec="CompoundDistribution" useThreads="true">\n')
    fh.write('        <distribution id="treeLikelihood.input_alignment" spec="ThreadedTreeLikelihood" data="@input_alignment" tree="@Tree.t:input_alignment">\n')
    if alpha_move:
        fh.write('          <siteModel id="SiteModel.s:input_alignment" spec="SiteModel" gammaCategoryCount="4" shape="@gammaShape.s:input_alignment">\n')
    else:
        fh.write('          <siteModel id="SiteModel.s:input_alignment" spec="SiteModel" gammaCategoryCount="0">\n')
    fh.write('            <parameter id="mutationRate.s:input_alignment" spec="parameter.RealParameter" estimate="false" lower="0.0" name="mutationRate">1.0</parameter>\n')
    fh.write('            <parameter id="proportionInvariant.s:input_alignment" spec="parameter.RealParameter" estimate="false" lower="0.0" name="proportionInvariant" upper="1.0">0.0</parameter>\n')
    fh.write('            <substModel id="hky.s:input_alignment" spec="HKY" kappa="@kappa.s:input_alignment">\n')
    fh.write('              <frequencies id="estimatedFreqs.s:input_alignment" spec="Frequencies" frequencies="@freqParameter.s:input_alignment"/>\n')
    fh.write("            </substModel>\n          </siteModel>\n")
    clock_ref = ('"@clockRate.c:input_alignment"' if mu_move
                 else f'"{float(hv.evo.mu) * 365.0:g}"')
    fh.write(f'          <branchRateModel id="StrictClock.c:input_alignment" spec="beast.base.evolution.branchratemodel.StrictClockModel" clock.rate={clock_ref}/>\n')
    fh.write("        </distribution>\n      </distribution>\n"
             "    </distribution>\n\n")

    # 2.7.7 operator set (beasty_input.cpp:845-946); sampled posterior is
    # operator-independent, so the newer kernels are used verbatim
    if mu_move:
        fh.write('    <operator id="StrictClockRateScaler.c:input_alignment" spec="AdaptableOperatorSampler" weight="1.5">\n')
        fh.write('      <parameter idref="clockRate.c:input_alignment"/>\n')
        fh.write('      <operator id="AVMNOperator.input_alignment" spec="kernel.AdaptableVarianceMultivariateNormalOperator" allowNonsense="true" beta="0.05" burnin="400" initial="800" weight="0.1">\n')
        fh.write('        <transformations id="AVMNSumTransform.input_alignment" spec="operator.kernel.Transform$LogConstrainedSumTransform">\n')
        fh.write('          <f idref="freqParameter.s:input_alignment"/>\n')
        fh.write("        </transformations>\n")
        fh.write('        <transformations id="AVMNLogTransform.input_alignment" spec="operator.kernel.Transform$LogTransform">\n')
        fh.write('          <f idref="clockRate.c:input_alignment"/>\n')
        if alpha_move:
            fh.write('          <f idref="gammaShape.s:input_alignment"/>\n')
        fh.write('          <f idref="kappa.s:input_alignment"/>\n')
        fh.write("        </transformations>\n")
        fh.write('        <transformations id="AVMNNoTransform.input_alignment" spec="operator.kernel.Transform$NoTransform">\n')
        fh.write('          <f idref="Tree.t:input_alignment"/>\n')
        fh.write("        </transformations>\n      </operator>\n")
        fh.write('      <operator id="StrictClockRateScalerX.c:input_alignment" spec="kernel.BactrianScaleOperator" parameter="@clockRate.c:input_alignment" upper="10.0" weight="3.0"/>\n')
        fh.write("    </operator>\n")
        fh.write('    <operator id="strictClockUpDownOperator.c:input_alignment" spec="AdaptableOperatorSampler" weight="1.5">\n')
        fh.write('      <parameter idref="clockRate.c:input_alignment"/>\n')
        fh.write('      <tree idref="Tree.t:input_alignment"/>\n')
        fh.write('      <operator idref="AVMNOperator.input_alignment"/>\n')
        fh.write('      <operator id="strictClockUpDownOperatorX.c:input_alignment" spec="operator.kernel.BactrianUpDownOperator" scaleFactor="0.75" weight="3.0">\n')
        fh.write('        <up idref="clockRate.c:input_alignment"/>\n')
        fh.write('        <down idref="Tree.t:input_alignment"/>\n')
        fh.write("      </operator>\n    </operator>\n")
    if alpha_move:
        fh.write('    <operator id="gammaShapeScaler.s:input_alignment" spec="AdaptableOperatorSampler" weight="0.05">\n')
        fh.write('      <parameter idref="gammaShape.s:input_alignment"/>\n')
        fh.write('      <operator idref="AVMNOperator.input_alignment"/>\n')
        fh.write('      <operator id="gammaShapeScalerX.s:input_alignment" spec="kernel.BactrianScaleOperator" parameter="@gammaShape.s:input_alignment" scaleFactor="0.5" upper="10.0" weight="0.1"/>\n')
        fh.write("    </operator>\n")
    fh.write('    <operator id="KappaScaler.s:input_alignment" spec="AdaptableOperatorSampler" weight="0.05">\n')
    fh.write('      <parameter idref="kappa.s:input_alignment"/>\n')
    fh.write('      <operator idref="AVMNOperator.input_alignment"/>\n')
    fh.write('      <operator id="KappaScalerX.s:input_alignment" spec="kernel.BactrianScaleOperator" parameter="@kappa.s:input_alignment" scaleFactor="0.1" upper="10.0" weight="0.1"/>\n')
    fh.write("    </operator>\n")
    fh.write('    <operator id="FrequenciesExchanger.s:input_alignment" spec="AdaptableOperatorSampler" weight="0.05">\n')
    fh.write('      <parameter idref="freqParameter.s:input_alignment"/>\n')
    fh.write('      <operator idref="AVMNOperator.input_alignment"/>\n')
    fh.write('      <operator id="FrequenciesExchangerX.s:input_alignment" spec="operator.kernel.BactrianDeltaExchangeOperator" delta="0.01" weight="0.1">\n')
    fh.write('        <parameter idref="freqParameter.s:input_alignment"/>\n')
    fh.write("      </operator>\n    </operator>\n")
    fh.write('    <operator id="CoalescentExponentialBICEPSEpochTop.t:input_alignment" spec="EpochFlexOperator" scaleFactor="0.1" tree="@Tree.t:input_alignment" weight="2.0"/>\n')
    fh.write('    <operator id="CoalescentExponentialBICEPSEpochAll.t:input_alignment" spec="EpochFlexOperator" fromOldestTipOnly="false" scaleFactor="0.1" tree="@Tree.t:input_alignment" weight="2.0"/>\n')
    fh.write('    <operator id="CoalescentExponentialBICEPSTreeFlex.t:input_alignment" spec="TreeStretchOperator" scaleFactor="0.01" tree="@Tree.t:input_alignment" weight="2.0"/>\n')
    fh.write('    <operator id="CoalescentExponentialTreeRootScaler.t:input_alignment" spec="kernel.BactrianScaleOperator" rootOnly="true" scaleFactor="0.1" tree="@Tree.t:input_alignment" upper="10.0" weight="3.0"/>\n')
    fh.write('    <operator id="CoalescentExponentialUniformOperator.t:input_alignment" spec="kernel.BactrianNodeOperator" tree="@Tree.t:input_alignment" weight="30.0"/>\n')
    fh.write('    <operator id="CoalescentExponentialSubtreeSlide.t:input_alignment" spec="kernel.BactrianSubtreeSlide" tree="@Tree.t:input_alignment" weight="15.0"/>\n')
    fh.write('    <operator id="CoalescentExponentialNarrow.t:input_alignment" spec="Exchange" tree="@Tree.t:input_alignment" weight="15.0"/>\n')
    fh.write('    <operator id="CoalescentExponentialWide.t:input_alignment" spec="Exchange" isNarrow="false" tree="@Tree.t:input_alignment" weight="3.0"/>\n')
    fh.write('    <operator id="CoalescentExponentialWilsonBalding.t:input_alignment" spec="WilsonBalding" tree="@Tree.t:input_alignment" weight="3.0"/>\n')
    if pop_size_move:
        fh.write('    <operator id="ePopSizeScaler.t:input_alignment" spec="kernel.BactrianScaleOperator" parameter="@ePopSize.t:input_alignment" upper="10.0" weight="3.0"/>\n')
    if pop_g_move:
        fh.write('    <operator id="GrowthRateRandomWalk.t:input_alignment" spec="operator.kernel.BactrianRandomWalkOperator" parameter="@growthRate.t:input_alignment" scaleFactor="0.1" weight="3.0"/>\n')
    # tip-date sampling operators (beasty_input.cpp:916-941)
    if uncertain:
        per_tip_w = 10.0 / len(uncertain)
        max_window = 1.0 / (tree.num_sites * float(hv.evo.mu) * 365.0)
        for i in uncertain:
            name = _xml_escape(tree.name[i])
            window = min(max_window,
                         (float(tree.t_max[i]) - float(tree.t_min[i])) / 4.0)
            fh.write(f'    <operator id="tip-operator.{name}" windowSize="{window:g}" spec="TipDatesRandomWalker" taxonset="@tip-taxonset.{name}" tree="@Tree.t:input_alignment" weight="{per_tip_w:g}"/>\n')
    fh.write("\n")

    # loggers: labels/order identical to 2.6.2 so output routines are shared
    fh.write(f'    <logger id="tracelog" spec="Logger" fileName="output.log" logEvery="{log_every}" model="@posterior" sanitiseHeaders="true">\n')
    for ref in ("posterior", "likelihood", "prior",
                "treeLikelihood.input_alignment"):
        fh.write(f'      <log idref="{ref}"/>\n')
    fh.write('      <log id="TreeHeight.t:input_alignment" spec="beast.base.evolution.tree.TreeStatLogger" tree="@Tree.t:input_alignment"/>\n')
    if mu_move:
        fh.write('      <log idref="clockRate.c:input_alignment"/>\n')
    if alpha_move:
        fh.write('      <log idref="gammaShape.s:input_alignment"/>\n')
    fh.write('      <log idref="kappa.s:input_alignment"/>\n')
    fh.write('      <log idref="Coalescent.t:input_alignment"/>\n')
    if pop_size_move:
        fh.write('      <log idref="ePopSize.t:input_alignment"/>\n')
    if pop_g_move:
        fh.write('      <log idref="growthRate.t:input_alignment"/>\n')
    fh.write('      <log idref="freqParameter.s:input_alignment"/>\n')
    for i in uncertain:
        fh.write(f'      <log idref="tip-dist.{_xml_escape(tree.name[i])}"/>\n')
    fh.write("    </logger>\n\n")
    fh.write('    <logger id="screenlog" spec="Logger" logEvery="1000">\n'
             '      <log idref="posterior"/>\n      <log idref="likelihood"/>\n'
             '      <log idref="prior"/>\n    </logger>\n\n')
    fh.write(f'    <logger id="treelog.t:input_alignment" spec="Logger" fileName="output.trees" logEvery="{tree_every}" mode="tree">\n')
    fh.write('      <log id="TreeWithMetaDataLogger.t:input_alignment" spec="beast.base.evolution.TreeWithMetaDataLogger" tree="@Tree.t:input_alignment"/>\n')
    fh.write("    </logger>\n\n")
    fh.write('    <operatorschedule id="OperatorSchedule" spec="OperatorSchedule"/>\n')
    fh.write("  </run>\n</beast>\n")


def export_beast_x_xml(fh, tree: FlatTree, run, chain_length: int = 10_000_000,
                       log_every: int = 10_000, tree_every: int = 10_000):
    """Write a BEAST X 10.5-style classic-format XML for the dataset held by
    `run` (reference export_beast_X_10_5_0_input, core/beasty_input.cpp:1075-
    1713): taxa with forward-dates (+uncertainty), alignment with missing
    sites as N, HKY + optional Gamma site model, strict clock, exponential /
    skygrid coalescent, standard operators and file/tree logs."""
    from .. import pop as popm

    if getattr(run, "mpox_hack", False):
        raise ValueError("BEAST XML export not supported with the mpox hack "
                         "(matches the reference's limitation)")

    T = tree.num_tips
    L = tree.num_sites
    hyp = run.hyp
    hv = run.host_view()
    skygrid = isinstance(run.pop, popm.SkygridPopParams)

    fh.write('<?xml version="1.0" standalone="yes"?>\n\n')
    fh.write('<!-- BEAST X 10.5 input generated by delphy-tpu for '
             'cross-validation -->\n')
    fh.write('<beast version="10.5.0-beta5">\n\n')

    # taxa with dates (forward years; uncertainty = upper - lower bound)
    fh.write(f'  <!-- ntax={T} -->\n  <taxa id="taxa">\n')
    for i in range(T):
        name = _xml_escape(tree.name[i])
        lo = to_linear_year(float(tree.t_min[i]))
        hi = to_linear_year(float(tree.t_max[i]))
        unc = (f' uncertainty="{hi - lo:.5f}"' if hi > lo else "")
        fh.write(f'    <taxon id="{name}">\n'
                 f'      <date value="{lo:.5f}" direction="forwards" '
                 f'units="years"{unc}/>\n    </taxon>\n')
    fh.write('  </taxa>\n\n')

    fh.write(f'  <!-- ntax={T} nchar={L} -->\n')
    fh.write('  <alignment id="alignment" dataType="nucleotide">\n')
    for i in range(T):
        s = tree.sequence_at(i)
        chars = np.array(list(seqm.real_to_str(s)))
        for l in sorted(tree.missing_sites_at(i)):
            chars[l] = "N"
        fh.write(f'    <sequence>\n      <taxon idref="{_xml_escape(tree.name[i])}"/>\n'
                 f'      {"".join(chars)}\n    </sequence>\n')
    fh.write('  </alignment>\n\n')

    fh.write('  <patterns id="patterns" from="1" strip="false">\n'
             '    <alignment idref="alignment"/>\n  </patterns>\n\n')

    # coalescent model + starting tree
    if not skygrid:
        n0y = float(hv.pop.n0) / 365.0
        gy = float(hv.pop.g) * 365.0
        fh.write('  <exponentialGrowth id="exponential" units="years">\n'
                 '    <populationSize>\n'
                 f'      <parameter id="exponential.popSize" value="{max(n0y, 1e-12):g}" lower="0.0"/>\n'
                 '    </populationSize>\n'
                 '    <growthRate>\n'
                 f'      <parameter id="exponential.growthRate" value="{gy:g}"/>\n'
                 '    </growthRate>\n  </exponentialGrowth>\n\n')
        fh.write('  <coalescentSimulator id="startingTree">\n'
                 '    <taxa idref="taxa"/>\n'
                 '    <exponentialGrowth idref="exponential"/>\n'
                 '  </coalescentSimulator>\n\n')
        tree_prior_block = (
            '    <coalescentLikelihood id="coalescent">\n'
            '      <model>\n        <exponentialGrowth idref="exponential"/>\n'
            '      </model>\n'
            '      <populationTree>\n        <treeModel idref="treeModel"/>\n'
            '      </populationTree>\n    </coalescentLikelihood>\n')
    else:
        M = int(np.asarray(hv.pop.gamma).shape[0])
        x = np.asarray(hv.pop.x)
        cutoff_years = (to_linear_year(float(run.t_max_tip))
                        - to_linear_year(float(x[0])))
        fh.write('  <constantSize id="initialDemo" units="years">\n'
                 '    <populationSize>\n'
                 '      <parameter id="initialDemo.popSize" value="100.0"/>\n'
                 '    </populationSize>\n  </constantSize>\n\n')
        fh.write('  <coalescentSimulator id="startingTree">\n'
                 '    <taxa idref="taxa"/>\n'
                 '    <constantSize idref="initialDemo"/>\n'
                 '  </coalescentSimulator>\n\n')
        tree_prior_block = (
            '    <gmrfSkyGridLikelihood id="skygrid">\n'
            '      <populationSizes>\n'
            f'        <parameter id="skygrid.logPopSize" dimension="{M}" value="1.0"/>\n'
            '      </populationSizes>\n'
            '      <precisionParameter>\n'
            '        <parameter id="skygrid.precision" value="0.1" lower="0.0"/>\n'
            '      </precisionParameter>\n'
            '      <numGridPoints>\n'
            f'        <parameter id="skygrid.numGridPoints" value="{M - 1}.0"/>\n'
            '      </numGridPoints>\n'
            '      <cutOff>\n'
            f'        <parameter id="skygrid.cutOff" value="{cutoff_years:g}"/>\n'
            '      </cutOff>\n'
            '      <populationTree>\n        <treeModel idref="treeModel"/>\n'
            '      </populationTree>\n    </gmrfSkyGridLikelihood>\n')

    fh.write('  <treeModel id="treeModel">\n'
             '    <coalescentTree idref="startingTree"/>\n'
             '    <rootHeight>\n'
             '      <parameter id="treeModel.rootHeight"/>\n'
             '    </rootHeight>\n'
             '    <nodeHeights internalNodes="true">\n'
             '      <parameter id="treeModel.internalNodeHeights"/>\n'
             '    </nodeHeights>\n'
             '    <nodeHeights internalNodes="true" rootNode="true">\n'
             '      <parameter id="treeModel.allInternalNodeHeights"/>\n'
             '    </nodeHeights>\n  </treeModel>\n\n')

    mu_per_year = float(hv.evo.mu) * 365.0
    fh.write('  <strictClockBranchRates id="branchRates">\n'
             '    <rate>\n'
             f'      <parameter id="clock.rate" value="{mu_per_year:g}" lower="0.0"/>\n'
             '    </rate>\n  </strictClockBranchRates>\n\n')

    pi = hv.evo.pi
    fh.write('  <HKYModel id="hky">\n'
             '    <frequencies>\n      <frequencyModel dataType="nucleotide">\n'
             '        <frequencies>\n'
             f'          <parameter id="frequencies" value="{pi[0]:.6g} {pi[1]:.6g} {pi[2]:.6g} {pi[3]:.6g}"/>\n'
             '        </frequencies>\n      </frequencyModel>\n    </frequencies>\n'
             '    <kappa>\n'
             f'      <parameter id="kappa" value="{float(hv.evo.kappa):g}" lower="0.0"/>\n'
             '    </kappa>\n  </HKYModel>\n\n')

    gamma = hyp.alpha_move_enabled
    fh.write('  <siteModel id="siteModel">\n'
             '    <substitutionModel>\n      <HKYModel idref="hky"/>\n'
             '    </substitutionModel>\n')
    if gamma:
        fh.write('    <gammaShape gammaCategories="4">\n'
                 f'      <parameter id="alpha" value="{float(hv.evo.alpha):g}" lower="0.0"/>\n'
                 '    </gammaShape>\n')
    fh.write('  </siteModel>\n\n')

    fh.write('  <treeDataLikelihood id="treeLikelihood" useAmbiguities="false">\n'
             '    <partition>\n      <patterns idref="patterns"/>\n'
             '      <siteModel idref="siteModel"/>\n    </partition>\n'
             '    <treeModel idref="treeModel"/>\n'
             '    <strictClockBranchRates idref="branchRates"/>\n'
             '  </treeDataLikelihood>\n\n')

    # operators
    fh.write('  <operators id="operators" optimizationSchedule="log">\n')
    fh.write('    <scaleOperator scaleFactor="0.75" weight="3">\n'
             '      <parameter idref="clock.rate"/>\n    </scaleOperator>\n')
    fh.write('    <scaleOperator scaleFactor="0.75" weight="1">\n'
             '      <parameter idref="kappa"/>\n    </scaleOperator>\n')
    fh.write('    <deltaExchange delta="0.01" weight="1">\n'
             '      <parameter idref="frequencies"/>\n    </deltaExchange>\n')
    if gamma:
        fh.write('    <scaleOperator scaleFactor="0.75" weight="1">\n'
                 '      <parameter idref="alpha"/>\n    </scaleOperator>\n')
    if not skygrid:
        fh.write('    <scaleOperator scaleFactor="0.75" weight="3">\n'
                 '      <parameter idref="exponential.popSize"/>\n    </scaleOperator>\n')
        fh.write('    <randomWalkOperator windowSize="1.0" weight="3">\n'
                 '      <parameter idref="exponential.growthRate"/>\n'
                 '    </randomWalkOperator>\n')
    else:
        fh.write('    <gmrfGridBlockUpdateOperator scaleFactor="2.0" weight="2">\n'
                 '      <gmrfSkyrideLikelihood idref="skygrid"/>\n'
                 '    </gmrfGridBlockUpdateOperator>\n')
        fh.write('    <scaleOperator scaleFactor="0.75" weight="1">\n'
                 '      <parameter idref="skygrid.precision"/>\n    </scaleOperator>\n')
    fh.write('    <subtreeSlide size="1.0" gaussian="true" weight="30">\n'
             '      <treeModel idref="treeModel"/>\n    </subtreeSlide>\n'
             '    <narrowExchange weight="30">\n'
             '      <treeModel idref="treeModel"/>\n    </narrowExchange>\n'
             '    <wideExchange weight="3">\n'
             '      <treeModel idref="treeModel"/>\n    </wideExchange>\n'
             '    <wilsonBalding weight="3">\n'
             '      <treeModel idref="treeModel"/>\n    </wilsonBalding>\n'
             '    <scaleOperator scaleFactor="0.75" weight="3">\n'
             '      <parameter idref="treeModel.rootHeight"/>\n    </scaleOperator>\n'
             '    <uniformOperator weight="30">\n'
             '      <parameter idref="treeModel.internalNodeHeights"/>\n'
             '    </uniformOperator>\n')
    fh.write('  </operators>\n\n')

    # mcmc + priors + logs
    stem = "delphy_beast_x"
    fh.write(f'  <mcmc id="mcmc" chainLength="{chain_length}" autoOptimize="true">\n')
    fh.write('    <joint id="joint">\n      <prior id="prior">\n')
    fh.write('        <ctmcScalePrior>\n'
             '          <ctmcScale>\n            <parameter idref="clock.rate"/>\n'
             '          </ctmcScale>\n'
             '          <treeModel idref="treeModel"/>\n'
             '        </ctmcScalePrior>\n')
    fh.write('        <logNormalPrior mu="1.0" sigma="1.25" offset="0.0">\n'
             '          <parameter idref="kappa"/>\n        </logNormalPrior>\n')
    if not skygrid:
        fh.write('        <oneOnXPrior>\n'
                 '          <parameter idref="exponential.popSize"/>\n'
                 '        </oneOnXPrior>\n')
        fh.write('        <laplacePrior mean="0.001" scale="30.701135">\n'
                 '          <parameter idref="exponential.growthRate"/>\n'
                 '        </laplacePrior>\n')
    else:
        fh.write('        <gammaPrior shape="0.001" scale="1000.0" offset="0.0">\n'
                 '          <parameter idref="skygrid.precision"/>\n'
                 '        </gammaPrior>\n')
    if gamma:
        fh.write('        <exponentialPrior mean="1.0" offset="0.0">\n'
                 '          <parameter idref="alpha"/>\n        </exponentialPrior>\n')
    fh.write('      </prior>\n      <likelihood id="likelihood">\n'
             '        <treeDataLikelihood idref="treeLikelihood"/>\n')
    fh.write(f'        {tree_prior_block}')
    fh.write('      </likelihood>\n    </joint>\n')
    fh.write('    <operators idref="operators"/>\n\n')
    fh.write(f'    <log id="screenLog" logEvery="{log_every}">\n'
             '      <column label="Joint" dp="4" width="12">\n'
             '        <joint idref="joint"/>\n      </column>\n    </log>\n')
    fh.write(f'    <log id="fileLog" logEvery="{log_every}" '
             f'fileName="{stem}.log" overwrite="false">\n'
             '      <joint idref="joint"/>\n      <prior idref="prior"/>\n'
             '      <likelihood idref="likelihood"/>\n'
             '      <parameter idref="treeModel.rootHeight"/>\n'
             '      <parameter idref="clock.rate"/>\n'
             '      <parameter idref="kappa"/>\n'
             '      <parameter idref="frequencies"/>\n')
    if gamma:
        fh.write('      <parameter idref="alpha"/>\n')
    if not skygrid:
        fh.write('      <parameter idref="exponential.popSize"/>\n'
                 '      <parameter idref="exponential.growthRate"/>\n')
    else:
        fh.write('      <parameter idref="skygrid.precision"/>\n'
                 '      <parameter idref="skygrid.logPopSize"/>\n'
                 '      <parameter idref="skygrid.cutOff"/>\n')
    fh.write('    </log>\n')
    fh.write(f'    <logTree id="treeFileLog" logEvery="{tree_every}" '
             f'nexusFormat="true" fileName="{stem}.trees" sortTranslationTable="true">\n'
             '      <treeModel idref="treeModel"/>\n'
             '      <trait name="rate" tag="rate">\n'
             '        <strictClockBranchRates idref="branchRates"/>\n'
             '      </trait>\n      <joint idref="joint"/>\n    </logTree>\n')
    fh.write('  </mcmc>\n\n')
    fh.write('  <report>\n    <property name="timer">\n'
             '      <mcmc idref="mcmc"/>\n    </property>\n  </report>\n')
    fh.write('</beast>\n')
